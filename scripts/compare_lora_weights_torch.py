#!/usr/bin/env python
"""Compare two LoRA safetensors files (diffusers / PEFT / qflux_tpu formats)
with the PyTorch port's tooling (qflux_tpu_torch/utils/model_compare.py):
the same report and exit code as scripts/compare_lora_weights.py, without
JAX.

Usage: python scripts/compare_lora_weights_torch.py a.safetensors b.safetensors [--rtol 1e-5]
Exit code 1 where any entry is not a match.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("file_a")
    ap.add_argument("file_b")
    ap.add_argument("--rtol", type=float, default=1e-5)
    args = ap.parse_args(argv)

    from qflux_tpu_torch.utils.model_compare import compare_lora_files, print_report, summarize

    diffs = compare_lora_files(args.file_a, args.file_b, rtol=args.rtol)
    print_report(diffs)
    bad = sum(v for k, v in summarize(diffs).items() if k != "match")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
