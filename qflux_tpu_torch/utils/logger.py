"""Metric, image and text logging over TensorBoard, wandb or SwanLab.

Counterpart of qflux_tpu/utils/logger.py (`make_grid`, `NullLogger`,
`LoggerManager` and its backends).  The JAX package writes TensorBoard
files with `tensorboardX`; the port has its own writer (`EventFileWriter`),
since the card's machine has neither tensorboardX nor protobuf.  It writes
what tensorboardX writes for the same calls:

  * records in TFRecord framing: the length as a little-endian uint64, its
    masked CRC32C, the data, the data's masked CRC32C (mask:
    ((crc >> 15) | (crc << 17)) + 0xa282ead8);
  * `Event` protobufs encoded by hand (wall_time = 1, step = 2,
    file_version = 3, summary = 5), the first carrying "brain.Event:2";
  * `Summary.Value`s: a scalar as `simple_value` (float32); text (and
    `log_table` / `log_hparams`, formatted as JAX formats them) as the text
    plugin's DT_STRING tensor under "<tag>/text_summary"; an image as a PNG
    (`utils/png.py`) with its height, width and channel count.

`read_event_scalars` reads the scalars of such a file back, its CRCs
checked.

wandb and swanlab are imported when chosen and degrade to `NullLogger`
with a warning where they are missing, as in JAX.
"""

from __future__ import annotations

import logging
import socket
import struct
import time
from pathlib import Path
from typing import Optional

import numpy as np

from qflux_tpu_torch.utils.png import encode_png


def make_grid(images: list[np.ndarray], ncols: int = 4, pad: int = 2) -> np.ndarray:
    """[H, W, 3] uint8 images → one grid image."""
    n = len(images)
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    grid = np.zeros((nrows * (h + pad) - pad, ncols * (w + pad) - pad, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, ncols)
        y, x = r * (h + pad), c * (w + pad)
        grid[y:y + im.shape[0], x:x + im.shape[1]] = im
    return grid


# ---------------------------------------------------------------------------
# TFRecord framing and protobuf encoding

def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord files use it."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s are ten bytes, two's complement
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", x)


def _double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


DT_STRING = 7


def scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value{tag = 1, simple_value = 2}."""
    return _bytes(1, tag.encode()) + _float(2, float(value))


def text_value(tag: str, text: str) -> bytes:
    """Summary.Value{tag = 1, tensor = 8, metadata = 9}: a [1] DT_STRING
    TensorProto{dtype = 1, tensor_shape = 2 {dim = 2 {size = 1}},
    string_val = 8} and SummaryMetadata{plugin_data = 1 {plugin_name = 1:
    "text"}} (its TextPluginData, version 0, encodes to nothing)."""
    shape = _bytes(2, _int(1, 1))
    tensor = _int(1, DT_STRING) + _bytes(2, shape) + _bytes(8, text.encode("utf-8"))
    metadata = _bytes(1, _bytes(1, b"text"))
    return _bytes(1, f"{tag}/text_summary".encode()) + _bytes(8, tensor) + _bytes(9, metadata)


def image_value(tag: str, image: np.ndarray) -> bytes:
    """Summary.Value{tag = 1, image = 4 {height = 1, width = 2,
    colorspace = 3, encoded_image_string = 4}}: an [H, W, C] image (uint8,
    or floats in [0, 1] scaled by 255 as tensorboardX scales them) as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (img.astype(np.float32) * 255).clip(0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    body = _int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, encode_png(img))
    return _bytes(1, tag.encode()) + _bytes(4, body)


def event(wall_time: float, step: int = 0, summary_values: list[bytes] = (),
          file_version: Optional[str] = None) -> bytes:
    """Event{wall_time = 1, step = 2, file_version = 3 | summary = 5 {value = 1}}."""
    out = _double(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    else:
        out += _bytes(5, b"".join(_bytes(1, v) for v in summary_values))
    return out


class EventFileWriter:
    """One `events.out.tfevents.<time>.<host>` file in `log_dir`, flushed
    after every event."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
        self._f = open(self.path, "ab")
        self._write(event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        self._f.write(tfrecord(data))
        self._f.flush()

    def add_values(self, values: list[bytes], step: int) -> None:
        self._write(event(time.time(), int(step), values))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    """The varint at buf[i:] and the index past it."""
    n = shift = 0
    while True:
        byte = buf[i]
        i += 1
        n |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return n, i


def _pb_fields(buf: bytes):
    """(field number, value) of a protobuf message: varints as ints,
    length-delimited fields as bytes, fixed32 / fixed64 as their bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            val, i = buf[i:i + size], i + size
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, val


def read_event_scalars(path: str | Path) -> dict:
    """{tag: [(step, value)]} of an events file's scalars (`simple_value`),
    every record's two masked CRC32Cs checked."""
    out: dict = {}
    data = Path(path).read_bytes()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        record = data[i + 12:i + 12 + n]
        (dcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(header) or dcrc != masked_crc32c(record):
            raise ValueError(f"{path}: bad CRC at byte {i}")
        i += 16 + n
        fields = list(_pb_fields(record))
        step = next((v for f, v in fields if f == 2), 0)
        for f, summary in fields:
            if f != 5:
                continue
            for _, value in _pb_fields(summary):
                v = dict(_pb_fields(value))
                if 2 in v:
                    out.setdefault(v[1].decode(), []).append(
                        (step, struct.unpack("<f", v[2])[0]))
    return out


# ---------------------------------------------------------------------------
# backends

class BaseLogger:
    def log_metrics(self, metrics: dict[str, float], step: int): ...
    def log_images(self, tag: str, images: list[np.ndarray], step: int, ncols: int = 4): ...
    def log_text(self, tag: str, text: str, step: int): ...
    def log_table(self, tag: str, rows: list[dict], step: int): ...
    def log_hparams(self, hparams: dict): ...
    def close(self): ...


class NullLogger(BaseLogger):
    pass


class TensorBoardLogger(BaseLogger):
    def __init__(self, log_dir: str | Path):
        self.writer = EventFileWriter(log_dir)

    def log_metrics(self, metrics, step):
        # one event per scalar, as tensorboardX's add_scalar
        for k, v in metrics.items():
            self.writer.add_values([scalar_value(k, float(v))], step)

    def log_images(self, tag, images, step, ncols=4):
        self.writer.add_values([image_value(tag, make_grid(images, ncols))], step)

    def log_text(self, tag, text, step):
        self.writer.add_values([text_value(tag, text)], step)

    def log_table(self, tag, rows, step):
        if not rows:
            return
        cols = list(rows[0])
        lines = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
        lines += ["| " + " | ".join(str(r.get(c, "")) for c in cols) + " |" for r in rows]
        self.log_text(tag, "\n".join(lines), step)

    def log_hparams(self, hparams):
        self.log_text("hparams", "```\n" + repr(hparams) + "\n```", 0)

    def close(self):
        self.writer.close()


class WandbLogger(BaseLogger):  # pragma: no cover - wandb is not installed here
    def __init__(self, project: str, config: Optional[dict] = None):
        import wandb

        self.run = wandb.init(project=project, config=config)
        self._wandb = wandb

    def log_metrics(self, metrics, step):
        self.run.log(metrics, step=step)

    def log_images(self, tag, images, step, ncols=4):
        self.run.log({tag: [self._wandb.Image(im) for im in images]}, step=step)

    def log_text(self, tag, text, step):
        self.run.log({tag: text}, step=step)

    def log_hparams(self, hparams):
        self.run.config.update(hparams, allow_val_change=True)

    def close(self):
        self.run.finish()


class SwanLabLogger(BaseLogger):  # pragma: no cover - swanlab is not installed here
    def __init__(self, project: str, config: Optional[dict] = None):
        import swanlab

        self.run = swanlab.init(project=project, config=config)
        self._swanlab = swanlab

    def log_metrics(self, metrics, step):
        self.run.log(metrics, step=step)

    def log_images(self, tag, images, step, ncols=4):
        self.run.log({tag: [self._swanlab.Image(im) for im in images]}, step=step)

    def close(self):
        self.run.finish()


class LoggerManager:
    """The backend `report_to` names; "none" (or a backend that is not
    installed, with a warning) logs nothing."""

    def __init__(self, report_to: str = "tensorboard", log_dir: str = "output/logs",
                 project: str = "qflux_tpu", config: Optional[dict] = None):
        self.backend: BaseLogger = NullLogger()
        if report_to in ("none", None):
            return
        try:
            if report_to == "tensorboard":
                self.backend = TensorBoardLogger(log_dir)
            elif report_to == "wandb":
                self.backend = WandbLogger(project, config)
            elif report_to == "swanlab":
                self.backend = SwanLabLogger(project, config)
            else:
                raise ValueError(f"unknown logging backend {report_to!r}")
        except ImportError as e:
            logging.warning("logging backend %s unavailable (%s); metrics disabled",
                            report_to, e)
        if config is not None:
            self.backend.log_hparams(config)

    def __getattr__(self, name):
        if name.startswith("log_") or name == "close":
            return getattr(self.backend, name)
        raise AttributeError(name)
