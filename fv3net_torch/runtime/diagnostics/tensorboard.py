"""TensorBoard diagnostics sink (port of
``fv3net_tpu/runtime/diagnostics/tensorboard.py``; reference:
workflows/prognostic_c48_run/runtime/diagnostics/tensorboard.py and
manager.py:40-60, where ``tensorboard: true`` on a diagnostics file routes
its variables to TensorBoard instead of zarr).

Host code, copied: TFRecord framing (length + masked CRC32C) around
hand-encoded ``Event`` protobuf messages (wall_time/step/Summary with
simple_value scalars and PNG image values), a standard
``events.out.tfevents.*`` file that TensorBoard reads.  The sink pulls a
step's variables from the device in one copy (``manager.pull``), in
their own precision.  Images are drawn with matplotlib as the reference
draws them; where matplotlib is missing the events hold the scalars
only, as the reference's do.
"""
from __future__ import annotations

import datetime
import io
import os
import socket
import struct
import time as _time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from fv3net_torch.core.quantity import Quantity

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if (_c & 1) else (_c >> 1)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoders (only what Event/Summary need).
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _string_field(field: int, value: str) -> bytes:
    return _bytes_field(field, value.encode("utf-8"))


def encode_image(height: int, width: int, png: bytes) -> bytes:
    """Summary.Image: height=1, width=2, colorspace=3 (RGBA=4),
    encoded_image_string=4."""
    return (
        _varint_field(1, height)
        + _varint_field(2, width)
        + _varint_field(3, 4)
        + _bytes_field(4, png)
    )


def encode_summary_value(
    tag: str,
    simple_value: Optional[float] = None,
    image: Optional[bytes] = None,
) -> bytes:
    """Summary.Value: tag=1, simple_value=2, image=4."""
    out = _string_field(1, tag)
    if simple_value is not None:
        out += _float_field(2, float(simple_value))
    if image is not None:
        out += _bytes_field(4, image)
    return out


def encode_event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    summary_values: Sequence[bytes] = (),
) -> bytes:
    """Event: wall_time=1 (double), step=2 (int64), file_version=3,
    summary=5 (Summary{value=repeated 1})."""
    out = _double_field(1, wall_time)
    if step is not None:
        out += _varint_field(2, step)
    if file_version is not None:
        out += _string_field(3, file_version)
    if summary_values:
        summary = b"".join(_bytes_field(1, v) for v in summary_values)
        out += _bytes_field(5, summary)
    return out


class EventFileWriter:
    """Append TFRecord-framed Event protos to an events file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(_time.time())}.{host}"
        )
        self._f = open(self.path, "wb")
        self.write_event(
            encode_event(_time.time(), file_version="brain.Event:2")
        )

    def write_event(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_events(path: str):
    """Decode the TFRecord framing back into raw Event payloads,
    verifying CRCs (test/debug utility)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("header CRC mismatch")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if dcrc != _masked_crc(data):
                raise ValueError("data CRC mismatch")
            out.append(data)


def _cube_to_png(arr: np.ndarray) -> Optional[tuple]:
    """Render a [tile, ny, nx] (or [ny, nx]) field as a PNG mosaic,
    returning (height, width, png_bytes)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib always present
        return None
    if arr.ndim == 3:  # [tile, ny, nx] -> tiles side by side
        arr = np.concatenate(list(arr), axis=-1)
    if arr.ndim != 2:
        return None
    fig, ax = plt.subplots(figsize=(max(4, arr.shape[1] / 48), 2.5))
    im = ax.imshow(arr, origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_xticks([])
    ax.set_yticks([])
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=72, bbox_inches="tight")
    plt.close(fig)
    png = buf.getvalue()
    return arr.shape[0], arr.shape[1], png


class TensorBoardSink:
    """DiagnosticFile-compatible sink: each observed time logs every
    selected variable as a scalar (global mean) and, for 2-D fields, a
    PNG image summary (reference tensorboard.py:14-25)."""

    def __init__(self, logdir: str, variables: Sequence[str], times,
                 images: bool = True):
        self._writer = EventFileWriter(logdir)
        self._variables = list(variables)
        self._times = times
        self._images = images
        self._step = 0

    def observe(self, time: datetime.datetime,
                diagnostics: Mapping[str, Quantity]) -> None:
        if self._times.indicator(time) is None:
            return
        from fv3net_torch.runtime.diagnostics.manager import pull

        present = [n for n in self._variables if n in diagnostics]
        # one device->host copy of the step's variables
        tensors = [torch.as_tensor(diagnostics[n].data) for n in present]
        arrays = pull(tensors, torch.float64 if any(
            t.dtype == torch.float64 for t in tensors) else torch.float32)
        values = []
        for name, arr in zip(present, arrays):
            values.append(
                encode_summary_value(
                    f"{name}/mean", simple_value=float(np.mean(arr))
                )
            )
            if self._images and arr.ndim in (2, 3):
                rendered = _cube_to_png(arr)
                if rendered is not None:
                    h, w, png = rendered
                    values.append(
                        encode_summary_value(
                            name, image=encode_image(h, w, png)
                        )
                    )
        if values:
            self._writer.write_event(
                encode_event(
                    _time.time(), step=self._step, summary_values=values
                )
            )
            self._writer.flush()
        self._step += 1

    def close(self) -> None:
        self._writer.close()
