"""Inline terminal graphics via the iTerm2 file-transfer protocol.

The reference ships an imgcat helper so `prognostic-run-diags shell`
sessions can look at plots without leaving the terminal
(reference workflows/diagnostics/fv3net/diagnostics/prognostic_run/
iterm.py).  This is a fresh implementation of the same PUBLIC protocol
(iTerm2 "1337;File" OSC sequence, with the tmux DCS passthrough
wrapping): terminals that support it (iTerm2, WezTerm, Konsole ≥22.04)
render the image inline; others print a short escape garble, so
``imgcat`` falls back to writing a file when the terminal is known not
to support it.

Host copy of ``fv3net_tpu/diagnostics/prognostic/iterm.py``.
"""
from __future__ import annotations

import base64
import io
import os
import sys
from typing import Optional

_ESC = b"\x1b"
_OSC = _ESC + b"]"
_CSI = _ESC + b"["
_BEL = b"\x07"


def terminal_supports_inline_images() -> bool:
    term_program = os.environ.get("TERM_PROGRAM", "")
    return term_program in ("iTerm.app", "WezTerm") or bool(
        os.environ.get("KONSOLE_VERSION", "")
    )


def write_image(
    buf: bytes,
    fp=None,
    filename: Optional[str] = None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    preserve_aspect_ratio: bool = True,
) -> None:
    """Emit ``buf`` (a PNG/JPEG byte string) as an inline image.

    ``width``/``height`` are in terminal cells.  Under tmux the sequence
    is wrapped in a DCS passthrough and cursor rows are reserved so the
    image does not overdraw the scrollback.
    """
    fp = fp if fp is not None else sys.stdout.buffer
    in_tmux = "tmux" in os.environ.get("TMUX", "")
    rows = height or 10

    if in_tmux:
        fp.write(b"\n" * rows)
        fp.write(_CSI + b"?25l")
        fp.write(_CSI + str(rows).encode() + b"F")
        fp.write(_ESC + b"Ptmux;" + _ESC)

    parts = [b"1337;File=inline=1", b"size=" + str(len(buf)).encode()]
    if filename:
        parts.append(b"name=" + base64.b64encode(filename.encode()))
    if width is not None:
        parts.append(b"width=" + str(width).encode())
    if height is not None:
        parts.append(b"height=" + str(height).encode())
    if not preserve_aspect_ratio:
        parts.append(b"preserveAspectRatio=0")
    fp.write(_OSC + b";".join(parts) + b":")
    fp.write(base64.b64encode(buf))
    fp.write(_BEL)

    if in_tmux:
        fp.write(_ESC + b"\\")
        fp.write(_CSI + str(rows).encode() + b"E")
        fp.write(_CSI + b"?25h")
    else:
        fp.write(b"\n")
    fp.flush()


def imgcat(fig, filename: str = "plot.png", fallback_dir: str = ".") -> str:
    """Show a matplotlib figure inline; if the terminal cannot render
    inline images, save it to ``fallback_dir`` instead.  Returns a
    description of what happened (for the shell banner)."""
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=110)
    data = buf.getvalue()
    if terminal_supports_inline_images() or os.environ.get(
        "FV3NET_FORCE_ITERM", ""
    ):
        write_image(data, filename=filename)
        return f"rendered {filename} inline"
    path = os.path.join(fallback_dir, filename)
    with open(path, "wb") as f:
        f.write(data)
    return f"terminal has no inline-image support; wrote {path}"
