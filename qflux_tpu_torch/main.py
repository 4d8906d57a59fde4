"""CLI: python -m qflux_tpu_torch.main --config cfg.yaml [--resume DIR]
[--profile DIR] [--device cuda|cpu]

Counterpart of qflux_tpu/main.py in fit mode: read the config (YAML, or
JSON where PyYAML is absent), build the resolution policy, the dataset
from data.class_path / data.init_args (data.caption_dropout_rate and
data.use_edit_mask as defaults) and the DataLoader from the data section
(batch_size, shuffle, drop_last, bucket_by_shape, num_workers, seeded
train.seed), then `Trainer.fit`.  The port trains from the embedding cache
(cache.use_cache and cache.cache_dir, e.g. written by the JAX package's
`--cache` pass).  The device defaults to cuda; `--device cpu` runs the
kernels' plain versions (tests, tiny models).

Not ported, each raising NotImplementedError with its ROADMAP.md queue-1
item: `--cache`, `--fit-no-cache` and `--predict` (the encoders, item 5),
`--distributed` (item 8), and `--plan` (XLA's memory analysis: not
ported at all).
"""

from __future__ import annotations

import argparse
import logging
import sys

from qflux_tpu_torch.data.preprocess import ITEM_5

ITEM_8 = "ROADMAP.md, queue 1 item 8: \"Distribution\""


def parse_args(argv=None):
    p = argparse.ArgumentParser("qflux_tpu_torch")
    p.add_argument("--config", required=True, help="YAML (or JSON) config path")
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--cache", action="store_true",
                   help="run the embedding-cache pass (not ported)")
    p.add_argument("--fit-no-cache", action="store_true",
                   help="train without the embedding cache (not ported)")
    p.add_argument("--predict", action="store_true", help="run inference (not ported)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 2-4 into DIR")
    p.add_argument("--plan", action="store_true", help="memory preflight (not ported)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    for flag, on in (("--cache", args.cache), ("--fit-no-cache", args.fit_no_cache),
                     ("--predict", args.predict)):
        if on:
            raise NotImplementedError(f"{flag} needs the VAE and text encoders, which are "
                                      f"not ported yet ({ITEM_5})")
    if args.distributed:
        raise NotImplementedError(f"--distributed is not ported yet ({ITEM_8})")
    if args.plan:
        raise NotImplementedError(
            "--plan (XLA memory_analysis) is not ported: it is on ROADMAP.md's \"Do not port\" "
            "list; measure torch.cuda.max_memory_allocated on the card instead")


def main(argv=None):
    """Fit from the config's embedding cache; returns the Trainer."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(process)d %(filename)s:%(lineno)d %(levelname)s %(message)s")
    args = parse_args(argv)
    _refuse_unported(args)

    from qflux_tpu_torch.config import load_config_from_yaml
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.utils.instantiate import instantiate_class

    config = load_config_from_yaml(args.config)
    if config.mode != "fit":
        raise NotImplementedError(f"mode {config.mode!r} needs the VAE and text encoders, "
                                  f"which are not ported yet ({ITEM_5})")
    if args.resume:
        config.resume = args.resume
    if args.profile:
        config.logging.profile_dir = args.profile

    data = config.data
    init_args = dict(data.init_args)
    init_args.setdefault("processor", ImageProcessor(data.processor))
    init_args.setdefault("caption_dropout_rate", data.caption_dropout_rate)
    init_args.setdefault("use_edit_mask", data.use_edit_mask)
    dataset = instantiate_class(data.class_path, **init_args)

    trainer = Trainer(config, device=args.device)
    dl = DataLoader(dataset, batch_size=data.batch_size, shuffle=data.shuffle,
                    drop_last=data.drop_last, seed=config.train.seed,
                    bucket_by_shape=data.bucket_by_shape, num_workers=data.num_workers)
    trainer.fit(dl)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
