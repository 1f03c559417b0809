"""Per-arch dumps of the reference, shared by the test files that split an
arch list between them.

A part of ``tests/_torch_lm_ref.py`` that takes arch names (``netes``,
``consensus``) is dumped one arch at a time, into a directory that every
pytest-xdist worker of one run shares, under a file lock: the first test
that needs an arch's dump makes it, and a test in another worker that
needs it at the same time waits for it. So the test files of one part,
each holding the cases of its own arch, make their dumps side by side,
and a test that reads every arch (the draws' own checks) finds the others'
dumps made, or makes what is missing.
"""
import fcntl
import os
import pathlib
import subprocess
import sys

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def shared_dir(tmp_path_factory) -> pathlib.Path:
    """A directory of this test run that every worker sees: the run's base
    temporary directory (each xdist worker's lies inside it)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "ref_dumps"
    path.mkdir(exist_ok=True)
    return path


class ArchDumps:
    """``part``'s dump as one mapping over ``archs``: a key
    ``<arch>/...`` is read from that arch's dump, made on first use; any
    other key (one every arch's dump holds, such as the graph's) from the
    ``home`` arch's (the test file's own), by default the first arch's."""

    def __init__(self, part: str, archs, directory: pathlib.Path,
                 home=None, timeout: int = 900):
        self.part, self.archs = part, tuple(archs)
        self.home = home or self.archs[0]
        self.directory, self.timeout = directory, timeout
        self._open = {}

    def _make(self, arch: str) -> pathlib.Path:
        path = self.directory / f"{self.part}-{arch}.npz"
        with open(path.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                tmp = path.with_name(f"tmp-{path.name}")
                env = dict(os.environ, JAX_PLATFORMS="cpu",
                           PYTHONPATH=str(SRC))
                res = subprocess.run(
                    [sys.executable, str(TESTS / "_torch_lm_ref.py"),
                     str(tmp), self.part, arch], env=env,
                    capture_output=True, text=True, timeout=self.timeout)
                assert res.returncode == 0, res.stderr[-4000:]
                tmp.rename(path)
        return path

    def dump(self, arch: str):
        """The lazily read npz of ``arch``."""
        if arch not in self._open:
            self._open[arch] = np.load(self._make(arch))
        return self._open[arch]

    def _of(self, key: str):
        head = key.split("/", 1)[0]
        return self.dump(head if head in self.archs else self.home)

    def __getitem__(self, key: str):
        return self._of(key)[key]

    def has(self, key: str) -> bool:
        return key in self._of(key).files

    def under(self, prefix: str) -> dict:
        """The entries below ``prefix`` ("<arch>/..."), keyed below it."""
        z = self._of(prefix)
        return {k[len(prefix) + 1:]: z[k] for k in z.files
                if k.startswith(prefix + "/")}

    def close(self) -> None:
        for z in self._open.values():
            z.close()
        self._open.clear()
