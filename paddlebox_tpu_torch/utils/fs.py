"""File-system helpers, local and HDFS/AFS (counterpart of
``paddlebox_tpu/utils/fs.py``, after the reference's ``BoxFileMgr``:
ls / exists / mkdir / remove / download / upload / touch). A path that
starts with ``hdfs:`` or ``afs:`` goes through the ``hadoop fs`` client
(``$HADOOP_HOME/bin/hadoop`` when ``HADOOP_HOME`` is set, else ``hadoop``
on the path); every other path is local.
"""

from __future__ import annotations

import glob as _glob
import os
import shutil
import subprocess
from typing import List


def _is_remote(path: str) -> bool:
    return path.startswith(("hdfs:", "afs:"))


def _hadoop(args: List[str], timeout: int = 300) -> str:
    home = os.environ.get("HADOOP_HOME")
    hadoop = os.path.join(home, "bin", "hadoop") if home else "hadoop"
    proc = subprocess.run([hadoop, "fs"] + args, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"hadoop fs {' '.join(args)}: {proc.stderr}")
    return proc.stdout


class FileMgr:
    """ls / exists / mkdir / remove / download / upload / touch, local or
    remote."""

    def ls(self, path: str) -> List[str]:
        if _is_remote(path):
            out = _hadoop(["-ls", path])
            return [parts[-1] for parts in map(str.split, out.splitlines())
                    if len(parts) >= 8]
        if os.path.isdir(path):
            return sorted(os.path.join(path, p) for p in os.listdir(path))
        return sorted(_glob.glob(path))

    def exists(self, path: str) -> bool:
        if _is_remote(path):
            try:
                _hadoop(["-test", "-e", path])
                return True
            except RuntimeError:
                return False
        return os.path.exists(path)

    def mkdir(self, path: str) -> None:
        if _is_remote(path):
            _hadoop(["-mkdir", "-p", path])
        else:
            os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        if _is_remote(path):
            _hadoop(["-rm", "-r", path])
        elif os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def download(self, remote: str, local: str) -> str:
        if _is_remote(remote):
            _hadoop(["-get", remote, local])
        elif os.path.abspath(remote) != os.path.abspath(local):
            shutil.copy(remote, local)
        return local

    def upload(self, local: str, remote: str) -> None:
        if _is_remote(remote):
            _hadoop(["-put", "-f", local, remote])
        elif os.path.abspath(local) != os.path.abspath(remote):
            os.makedirs(os.path.dirname(remote) or ".", exist_ok=True)
            shutil.copy(local, remote)

    def touch(self, path: str) -> None:
        if _is_remote(path):
            _hadoop(["-touchz", path])
        else:
            open(path, "a").close()
