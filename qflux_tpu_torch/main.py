"""CLI: python -m qflux_tpu_torch.main --config cfg.yaml
[--cache | --fit-no-cache | --predict --control IMG [--control IMG2 …]
--prompt TEXT [--output out.png] [--steps N]] [--resume DIR]
[--profile DIR] [--device cuda|cpu]

Counterpart of qflux_tpu/main.py: read the config (YAML, or JSON where
PyYAML is absent), build the resolution policy, the dataset from
data.class_path / data.init_args (data.caption_dropout_rate and
data.use_edit_mask as defaults) and the DataLoader, then

  * fit (the default): `Trainer.fit` over the data section's loader
    (batch_size, shuffle, drop_last, bucket_by_shape, num_workers, seeded
    train.seed), from the embedding cache where cache.use_cache and a
    cache_dir are set, samples not in it encoded as they come;
  * --fit-no-cache: the same with the cache off (every batch encoded);
  * --cache: `Trainer.cache` over bs=1 batches in order, conditioning
    dropout off, into cache.cache_dir;
  * --predict: `Trainer.predict` on the control image(s) (`--control`, or
    JAX's name for it, `--image`) and `--prompt`, each output written as a
    PNG by the port's own encoder (`--output`, then -1, -2, … for more).

--cache, --fit-no-cache and --predict run the family's encoders, for every
trainer of JAX's (FLUX.1-Kontext and DreamOmni2: CLIP-L, T5-XXL and the VAE
encoder, with DreamOmni2's Qwen2.5-VL prompt enhancer where it is on;
Qwen-Image-Edit and -Plus: Qwen2.5-VL and the 3D VAE encoder; FLUX.2-Klein:
Qwen3 and the VAE encoder).  The device defaults to cuda; `--device
cpu` runs the kernels' plain versions (tests, tiny models).

--distributed joins the process group from torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as JAX calls
`jax.distributed.initialize()`: NCCL on cuda (this rank's device
cuda:LOCAL_RANK), gloo only with `--device cpu`; a failed rendezvous
raises.  The Trainer then builds config.mesh over the ranks (dp, fsdp and
sp run; tp > 1 raises, naming queue 1 item 8b):

    torchrun --nproc-per-node N -m qflux_tpu_torch.main --distributed --config cfg.yaml

Every rank iterates the same seeded loader order and takes its own rows of
each batch (`Trainer._rank_rows`), as JAX's processes do; only the main
rank writes files (the run dir's logs and checkpoints, --predict's
images, the cache).  A rank's exception ends the run with a non-zero exit.
Not ported: `--plan` (XLA's memory analysis: on the "Do not port" list).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

PREDICT_ONLY = ("control", "prompt", "output", "steps")


def parse_args(argv=None):
    p = argparse.ArgumentParser("qflux_tpu_torch")
    p.add_argument("--config", required=True, help="YAML (or JSON) config path")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--cache", action="store_true", help="run the embedding-cache pass")
    p.add_argument("--fit-no-cache", action="store_true",
                   help="train without the embedding cache")
    p.add_argument("--predict", action="store_true",
                   help="edit --control image(s) by --prompt and write --output")
    p.add_argument("--control", "--image", dest="control", action="append", default=None,
                   help="control image path for --predict (repeatable)")
    p.add_argument("--prompt", default=None, help="edit instruction for --predict")
    p.add_argument("--output", default=None, help="output PNG path for --predict "
                   "(default prediction.png)")
    p.add_argument("--steps", type=int, default=None, help="inference steps for --predict")
    p.add_argument("--distributed", action="store_true",
                   help="join torchrun's process group (NCCL on cuda, gloo on cpu)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 2-4 into DIR")
    p.add_argument("--plan", action="store_true", help="memory preflight (not ported)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    if not args.predict:
        given = [f"--{k}" for k in PREDICT_ONLY if getattr(args, k) is not None]
        if given:
            p.error(f"{', '.join(given)} act only with --predict")
    return args


def _refuse_unported(args) -> None:
    if args.plan:
        raise NotImplementedError(
            "--plan (XLA memory_analysis) is not ported: it is on ROADMAP.md's \"Do not port\" "
            "list; measure torch.cuda.max_memory_allocated on the card instead")


def _predict(trainer, args) -> list:
    """--predict: read the controls, edit, write every output image."""
    from qflux_tpu_torch.data.dataset import _read_image
    from qflux_tpu_torch.parallel.collectives import is_main_process
    from qflux_tpu_torch.utils.png import encode_png

    if not args.control or args.prompt is None:
        raise SystemExit("--predict requires --control (repeatable) and --prompt")
    controls = [_read_image(p) for p in args.control]
    controls = [c if c.ndim == 3 else c[:, :, None].repeat(3, axis=2) for c in controls]
    imgs = trainer.predict(controls, args.prompt, num_inference_steps=args.steps)
    output = args.output or "prediction.png"
    stem, ext = os.path.splitext(output)
    paths = []
    for i, im in enumerate(imgs):
        path = output if i == 0 else f"{stem}-{i}{ext}"
        if is_main_process():  # every rank edits (in step, over a sharded base); one writes
            with open(path, "wb") as f:
                f.write(encode_png(im))
            logging.info("wrote %s", path)
        paths.append(path)
    return paths


def main(argv=None):
    """Run the config's mode; returns the Trainer."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(process)d %(filename)s:%(lineno)d %(levelname)s %(message)s")
    args = parse_args(argv)
    _refuse_unported(args)
    device = args.device
    if args.distributed:
        from qflux_tpu_torch.parallel.mesh import init_distributed

        device = str(init_distributed(args.device))

    from qflux_tpu_torch.config import load_config_from_yaml
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.utils.instantiate import instantiate_class

    config = load_config_from_yaml(args.config)
    if args.resume:
        config.resume = args.resume
    if args.cache:
        config.mode = "cache"
        config.cache.use_cache = True
    if args.fit_no_cache:
        config.mode = "fit"
        config.cache.use_cache = False
        config.data.init_args.pop("use_cache", None)
    if args.predict:
        config.mode = "predict"
    if args.profile:
        config.logging.profile_dir = args.profile

    trainer = Trainer(config, device=device)
    if config.mode == "predict":
        trainer.last_outputs = _predict(trainer, args)
        return trainer
    if config.mode not in ("fit", "cache"):
        raise ValueError(f"unknown mode {config.mode!r}")

    data = config.data
    init_args = dict(data.init_args)
    init_args.setdefault("processor", ImageProcessor(data.processor))
    init_args.setdefault("caption_dropout_rate", data.caption_dropout_rate)
    init_args.setdefault("use_edit_mask", data.use_edit_mask)
    dataset = instantiate_class(data.class_path, **init_args)

    if config.mode == "cache":
        # bs=1, in order, every sample kept; conditioning dropout must not
        # bake into the cache (it is drawn again at each cached load)
        dataset.caption_dropout_rate = 0.0
        dataset.prompt_image_dropout_rate = 0.0
        trainer.cache(DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False,
                                 bucket_by_shape=False))
        return trainer
    dl = DataLoader(dataset, batch_size=data.batch_size, shuffle=data.shuffle,
                    drop_last=data.drop_last, seed=config.train.seed,
                    bucket_by_shape=data.bucket_by_shape, num_workers=data.num_workers)
    trainer.fit(dl)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
