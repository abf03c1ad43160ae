"""Filesystem conveniences (a copy of the host-only
``fv3net_tpu/core/filesystem.py``; ``open_remote_nc`` reads through the
port's ``core/netcdfio.py``).

reference: external/vcm/vcm/cloud/fsspec.py (``get_fs``/``to_url``/
``get_protocol``), vcm/xarray_loaders.py:26 (``open_remote_nc``) and
vcm/extract.py:9 (``extract_tarball_to_path``).  The reference resolves
any fsspec protocol (gs://, file://); this build runs in a zero-egress
environment, so local paths are first-class and remote protocols can be
redirected to a local mirror via the ``FV3NET_FS_MIRROR`` environment
variable (``gs://bucket/key`` -> ``$FV3NET_FS_MIRROR/bucket/key``),
failing with a clear error otherwise.
"""
from __future__ import annotations

import glob as _glob
import io
import os
import tarfile
from pathlib import Path
from typing import List, Optional


def get_protocol(path: str) -> str:
    """'gs://b/k' -> 'gs'; plain paths -> 'file' (reference
    fsspec.py:12-19)."""
    if "://" in path:
        return path.split("://", 1)[0]
    return "file"


class LocalFileSystem:
    """The fsspec-shaped subset the framework uses: ls/glob/open/cat/
    exists/makedirs, all against the local filesystem (possibly through
    the FV3NET_FS_MIRROR redirection for remote-protocol URLs)."""

    protocol = "file"

    def _strip(self, path: str) -> str:
        if "://" not in path:
            return path
        proto, rest = path.split("://", 1)
        if proto == "file":
            return rest
        mirror = os.environ.get("FV3NET_FS_MIRROR")
        if mirror:
            return os.path.join(mirror, rest)
        raise OSError(
            f"remote protocol {proto!r} is unreachable in this zero-egress"
            " environment; set FV3NET_FS_MIRROR to a local mirror root"
        )

    def ls(self, path: str) -> List[str]:
        path = self._strip(path)
        return sorted(
            os.path.join(path, name) for name in os.listdir(path)
        )

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(self._strip(pattern)))

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self._strip(path))

    def open(self, path: str, mode: str = "rb"):
        path = self._strip(path)
        if any(m in mode for m in "wa"):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, mode)

    def cat(self, path: str) -> bytes:
        with self.open(path, "rb") as f:
            return f.read()

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(self._strip(path), exist_ok=exist_ok)

    def get(self, src: str, dst: str) -> None:
        import shutil

        shutil.copy(self._strip(src), dst)


def get_fs(path: str) -> LocalFileSystem:
    """Filesystem object for ``path`` (reference fsspec.py:22-24)."""
    # every protocol resolves to the local filesystem (see module doc);
    # constructing the FS is cheap and validation happens on access
    return LocalFileSystem()


def to_url(fs, path: str) -> str:
    """Filesystem + bare path -> URI (reference fsspec.py:27-44)."""
    proto = getattr(fs, "protocol", "file")
    if isinstance(proto, (list, tuple)):
        proto = proto[0]
    if proto == "file":
        return path
    return f"{proto}://{path}"


def open_remote_nc(fs, url: str):
    """Read a whole netCDF through the filesystem object and parse it
    in memory (reference xarray_loaders.py:26-30)."""
    from fv3net_torch.core.netcdfio import open_netcdf

    data = fs.cat(url)
    return open_netcdf(io.BytesIO(data))


def extract_tarball_to_path(
    source_tar_path: Path, extract_to_dir: Optional[Path] = None
) -> Path:
    """Untar ``source_tar_path`` (reference extract.py:9-24); the target
    defaults to the tarball name without its suffix."""
    source_tar_path = Path(source_tar_path)
    if extract_to_dir is None:
        extract_to_dir = source_tar_path.with_suffix("")
    extract_to_dir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(source_tar_path) as tar:
        tar.extractall(path=extract_to_dir, filter="data")
    return extract_to_dir
