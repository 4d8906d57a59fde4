"""HF Hub I/O: the editing-dataset schema, LoRA upload and download.

Counterpart of qflux_tpu/utils/hub.py:
  * the editing-dataset schema {id, control_images[], control_mask,
    target_image, prompt} and its records built from a local folder
    dataset (`data/dataset.py:ImageDataset`), with no network;
  * a LoRA's download (a local path is returned as it is) and its upload
    under a content-hash name, loras/<sha256[:12]>/<file name>
    (`huggingface_hub`).

Every network operation imports its package inside the call and raises a
RuntimeError saying what it would have done where the package is absent or
the hub unreachable; `Trainer.fit` only warns when its push fails, as the
JAX trainer does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

from qflux_tpu_torch.data.dataset import is_huggingface_repo  # noqa: F401 (re-exported)
from qflux_tpu_torch.utils.hashing import sha256_file

EDITING_DATASET_FEATURES = {
    "id": "string",
    "control_images": "sequence<image>",
    "control_mask": "image",
    "target_image": "image",
    "prompt": "string",
}


def build_editing_records(dataset_root: str | Path) -> list[dict[str, Any]]:
    """A local folder dataset → editing-schema records (file paths; no
    network)."""
    from qflux_tpu_torch.data.dataset import ImageDataset

    ds = ImageDataset(dataset_path=str(dataset_root))
    return [{"id": f"{i:06d}", "control_images": list(s.get("controls") or []),
             "control_mask": s.get("mask_file"), "target_image": s["image"],
             "prompt": ds._prompt_of(s)}
            for i, s in enumerate(ds.samples)]


def download_lora(repo_id: str, filename: str = "pytorch_lora_weights.safetensors",
                  cache_dir: Optional[str] = None) -> Path:
    """A LoRA file from the hub, or `repo_id` itself where it is a local
    path (a directory: its `filename`)."""
    local = Path(repo_id)
    if local.exists():
        return local if local.is_file() else local / filename
    try:
        from huggingface_hub import hf_hub_download

        return Path(hf_hub_download(repo_id, filename, cache_dir=cache_dir))
    except Exception as e:
        raise RuntimeError(f"hub download unavailable ({e}); wanted {repo_id}/{filename}") from e


def upload_lora_safetensors(path: str | Path, repo_id: str, private: bool = True) -> str:
    """Upload a LoRA file under its content-hash name; returns that name."""
    path = Path(path)
    dest = f"loras/{sha256_file(path)[:12]}/{path.name}"
    try:
        from huggingface_hub import HfApi

        api = HfApi()
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_file(path_or_fileobj=str(path), path_in_repo=dest, repo_id=repo_id)
        return dest
    except Exception as e:
        raise RuntimeError(f"hub upload unavailable ({e}); would upload to {dest}") from e
