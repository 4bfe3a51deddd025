"""Pluggable filesystem layer — the port's copy of ``deequ_tpu/data/fs.py``
(the analogue of the reference's Hadoop-FS indirection,
io/DfsUtils.scala:24-85): state files live on local disk, in memory, or
on an object store behind one interface.

``filesystem_for(path)`` resolves a FileSystem from the path's scheme:

- no scheme / ``file://``  -> LocalFileSystem;
- a scheme registered with ``register_filesystem(scheme, factory)``;
- any other scheme (``gs://``, ``s3://``) -> FsspecFileSystem, which needs
  the optional ``fsspec`` package (imported only then) and raises
  ImportError, naming it, where it is not installed.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Dict, List


class FileSystem:
    """The filesystem interface the state providers need."""

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Replace ``dst`` with ``src`` (the commit step of the
        write-temp-fsync-rename protocol, resilience/atomic.py). Default:
        copy + delete; override with the store's atomic rename."""
        with self.open(src, "rb") as f:
            data = f.read()
        with self.open(dst, "wb") as f:
            f.write(data)
        self.delete(src)

    def join(self, *parts: str) -> str:
        return "/".join(p.rstrip("/") for p in parts[:-1]) + "/" + parts[-1]


class LocalFileSystem(FileSystem):
    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def delete(self, path: str) -> None:
        if os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)  # POSIX atomic replace

    def join(self, *parts: str) -> str:
        return os.path.join(*parts)


class FsspecFileSystem(FileSystem):
    """Remote object stores (GCS/S3/...) through fsspec, where installed."""

    def __init__(self, scheme: str):
        try:
            import fsspec
        except ImportError as e:
            raise ImportError(
                f"paths with scheme '{scheme}://' need the optional 'fsspec' "
                f"package (plus gcsfs for gs:// or s3fs for s3://)"
            ) from e
        self._fs = fsspec.filesystem(scheme)
        self.scheme = scheme

    def open(self, path: str, mode: str = "rb"):
        return self._fs.open(path, mode)

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(path, exist_ok=True)

    def listdir(self, path: str) -> List[str]:
        return sorted(p.rsplit("/", 1)[-1] for p in self._fs.ls(path, detail=False))

    def delete(self, path: str) -> None:
        if self._fs.exists(path):
            self._fs.rm(path)

    def rename(self, src: str, dst: str) -> None:
        # object stores rename by copy + delete; their single-object puts
        # are all-or-nothing already
        self._fs.mv(src, dst)


class InMemoryFileSystem(FileSystem):
    """Dict-backed filesystem (tests and ephemeral runs)."""

    def __init__(self):
        self.files: Dict[str, bytes] = {}

    def open(self, path: str, mode: str = "rb"):
        if "r" in mode:
            if path not in self.files:
                raise FileNotFoundError(path)
            data = self.files[path]
            return io.BytesIO(data) if "b" in mode else io.StringIO(data.decode())
        fs = self

        class _Writer(io.BytesIO if "b" in mode else io.StringIO):  # type: ignore[misc]
            def close(inner):
                payload = inner.getvalue()
                fs.files[path] = (
                    payload if isinstance(payload, bytes) else payload.encode()
                )
                super().close()

        return _Writer()

    def exists(self, path: str) -> bool:
        return path in self.files or any(
            k.startswith(path.rstrip("/") + "/") for k in self.files
        )

    def makedirs(self, path: str) -> None:
        pass  # directories are implicit

    def listdir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/"
        return sorted(k[len(prefix):] for k in self.files if k.startswith(prefix))

    def delete(self, path: str) -> None:
        self.files.pop(path, None)

    def rename(self, src: str, dst: str) -> None:
        if src not in self.files:
            raise FileNotFoundError(src)
        self.files[dst] = self.files.pop(src)


_REGISTRY: Dict[str, Callable[[str], FileSystem]] = {}
_LOCAL = LocalFileSystem()


def register_filesystem(scheme: str, factory: Callable[[str], FileSystem]) -> None:
    """Register a FileSystem factory for a URL scheme (tests register an
    in-memory one; a deployment an authenticated client)."""
    _REGISTRY[scheme] = factory


def filesystem_for(path: str) -> FileSystem:
    """The FileSystem responsible for ``path``, by URL scheme."""
    if "://" in path:
        scheme = path.split("://", 1)[0]
        if scheme == "file":
            return _LOCAL
        if scheme in _REGISTRY:
            return _REGISTRY[scheme](path)
        return FsspecFileSystem(scheme)
    return _LOCAL


def strip_scheme(path: str) -> str:
    """file:///x -> /x; other schemes keep the full URL (their filesystem
    expects it)."""
    if path.startswith("file://"):
        return path[len("file://"):]
    return path
