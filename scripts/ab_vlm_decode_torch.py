"""A/B of two checkouts of the PyTorch port on one card: the KV-cached greedy
decode of Qwen2.5-VL's language model at full width (28 layers × 3,584, f32,
the LM head over the 152,064-token vocabulary), as DreamOmni2's prompt
enhancer runs it (trainer/dreamomni2.py:enhance_prompt).  The decode is
host-bound: every step is ~200 small f32 products, so it shows what each
dense layer's Python costs.

    python3 scripts/ab_vlm_decode_torch.py PARENT [CHANGE]

PARENT and CHANGE are unpacked checkouts (git archive); CHANGE defaults to
the checkout holding this script.  Each side runs in a process of its own
with its checkout first on sys.path, in turns parent, change, change,
parent.  Each draws the LM and its head on the card from seeds 12 / 13 (as
chip_smoke.py's phase H does), prefills PROMPT random token ids at text
positions, then decodes STEPS greedy tokens; a token's time is (the last
step's launch - the first's) / (STEPS - 1) on the host clock, each step
ending in its argmax read, as chip_smoke.py's `_KVRecord` times it.
Prints the card's name and power limit, each run's prefill and token ms,
the means per side and their ratio, and whether the generated ids and the
last hidden state are identical to the bit across the four runs; writes
the runs to chiprun_out/ab_vlm_decode.json.  Exits non-zero when they
differ or the card is missing.  Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PROMPT, STEPS = 665, 64


def child() -> None:
    from qflux_tpu_torch.models.qwen import vl_encoder as tvl
    from qflux_tpu_torch.ops.layers import dense
    from qflux_tpu_torch.trainer import dreamomni2 as td2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tvl.VLTextConfig()
    lm = tvl.text_init(torch.Generator("cuda").manual_seed(12), cfg, "cuda")
    head = td2.lm_head_init(torch.Generator("cuda").manual_seed(13), cfg, "cuda")
    ids = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab_size, PROMPT))
    embeds = lm.embed_tokens[ids[None].to(lm.embed_tokens.device)]
    pos = np.broadcast_to(np.arange(PROMPT)[None, None], (3, 1, PROMPT)).copy()
    cache = tvl.make_kv_cache(cfg, 1, PROMPT + STEPS, embeds.dtype, "cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, cache = tvl.text_prefill(lm, cfg, embeds, pos, cache)
        nxt = int(torch.argmax(dense(head, hidden[0, -1])))
        prefill_ms = 1000 * (time.perf_counter() - t0)
        generated, launch = [], []
        for step in range(STEPS):
            generated.append(nxt)
            launch.append(time.perf_counter())
            step_pos = np.full((3, 1, 1), PROMPT + step, np.int64)
            emb = lm.embed_tokens[torch.tensor([[nxt]], device="cuda")]
            hidden, cache = tvl.text_decode_step(lm, cfg, emb, step_pos, cache, PROMPT + step)
            nxt = int(torch.argmax(dense(head, hidden[0])))
    digest = hashlib.sha256(np.asarray(generated + [nxt]).tobytes()
                            + hidden.float().cpu().numpy().tobytes()).hexdigest()[:16]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("AB_DECODE " + json.dumps({
        "prefill_ms": prefill_ms, "token_ms": 1000 * (launch[-1] - launch[0]) / (STEPS - 1),
        "digest": digest, "card": card.stdout.strip().splitlines()[0]}), flush=True)


def main(parent: str, change: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    here = Path(__file__).resolve()
    trees = {"parent": Path(parent).resolve(), "change": Path(change).resolve()}
    runs = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent"):
        code = ("import importlib.util, sys; sys.path.insert(0, %r); "
                "spec = importlib.util.spec_from_file_location('ab_decode', %r); "
                "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
                "m.child()" % (str(trees[tag]), str(here)))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=trees[tag], timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_DECODE ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs[tag].append(json.loads(lines[-1][len("AB_DECODE "):]))
    card = runs["change"][0]["card"]
    every = runs["parent"] + runs["change"]
    same = all(r["digest"] == every[0]["digest"] for r in every)
    for key in ("prefill_ms", "token_ms"):
        p = [r[key] for r in runs["parent"]]
        c = [r[key] for r in runs["change"]]
        print(f"[ab_decode] {key}: parent {statistics.mean(p):.2f} "
              f"({', '.join(f'{t:.2f}' for t in p)}), change {statistics.mean(c):.2f} "
              f"({', '.join(f'{t:.2f}' for t in c)}), parent / change "
              f"{statistics.mean(p) / statistics.mean(c):.3f} [{card}]", flush=True)
    print(f"[ab_decode] {PROMPT}-token prompt, {STEPS} greedy tokens; ids and last hidden "
          f"state identical across the four runs: {same} [{card}]", flush=True)
    out = here.parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_vlm_decode.json").write_text(json.dumps(runs, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else
                  str(Path(__file__).resolve().parent.parent)))
