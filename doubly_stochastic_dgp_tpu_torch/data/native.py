"""ctypes binding of the host CSV loader (``native/csvloader.cpp``):
multithreaded CSV parsing, deterministic shuffled-index streams and
contiguous row gathering, with a numpy fallback of the same API where the
library cannot be built (no ``g++``).

Counterpart of ``doubly_stochastic_dgp_tpu/data/native.py``.  This is a
host data path, not a device one.  The library is built at first use with
``g++`` into ``build/native/`` of the checkout (written to a temporary
name and renamed, so processes that build at once never load a partial
file).  The numpy fallback reads CSVs with ``numpy.loadtxt`` where the
JAX package uses pandas, and shuffles with ``numpy.random.RandomState``,
whose permutations differ from the library's.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["get_lib", "native_available", "read_csv", "read_csv_numpy",
           "shuffled_indices", "shuffled_indices_numpy", "gather_rows",
           "MinibatchStream", "PrefetchingLoader"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO_ROOT, "native", "csvloader.cpp")
_LIB_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB = os.path.join(_LIB_DIR, "libcsvloader.so")


class _Loader:
    """The library, built and loaded once per process (None when it
    cannot be built)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False


_loader = _Loader()


def _compile() -> bool:
    if not os.path.isfile(_SRC):
        return False
    os.makedirs(_LIB_DIR, exist_ok=True)
    if (os.path.isfile(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return True
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, _SRC, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def _bind(lib):
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.csv_read.restype = ctypes.c_int
    lib.csv_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(dp), ip, ip]
    lib.csv_free.restype = None
    lib.csv_free.argtypes = [dp]
    lib.shuffled_indices.restype = None
    lib.shuffled_indices.argtypes = [ctypes.c_int64, ctypes.c_uint64, ip]
    lib.gather_rows.restype = None
    lib.gather_rows.argtypes = [dp, ctypes.c_int64, ip, ctypes.c_int64, dp]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it cannot be built."""
    with _loader.lock:
        if not _loader.tried:
            _loader.tried = True
            if _compile():
                try:
                    _loader.lib = _bind(ctypes.CDLL(_LIB))
                except OSError:   # built for another system: fall back
                    _loader.lib = None
        return _loader.lib


def native_available() -> bool:
    return get_lib() is not None


def read_csv_numpy(path: str, skip_header: bool = False) -> np.ndarray:
    """The fallback of :func:`read_csv`."""
    return np.loadtxt(path, delimiter=",", skiprows=int(skip_header),
                      ndmin=2, dtype=np.float64)


def read_csv(path: str, skip_header: bool = False) -> np.ndarray:
    """Parse a numeric CSV into an (N, D) float64 array."""
    lib = get_lib()
    if lib is None:
        return read_csv_numpy(path, skip_header)
    data_p = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.csv_read(path.encode(), int(skip_header), ctypes.byref(data_p),
                      ctypes.byref(rows), ctypes.byref(cols))
    if rc < 0:
        raise IOError(f"csv_read({path}) failed with code {rc}")
    try:
        arr = np.ctypeslib.as_array(data_p,
                                    shape=(rows.value, cols.value)).copy()
    finally:
        lib.csv_free(data_p)
    return arr


def shuffled_indices_numpy(n: int, seed: int) -> np.ndarray:
    """The fallback of :func:`shuffled_indices` (another permutation)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    idx = np.arange(n, dtype=np.int64)
    rng.shuffle(idx)
    return idx


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """A deterministic permutation of arange(n) (the library's
    Fisher-Yates, or numpy's shuffle in the fallback)."""
    lib = get_lib()
    if lib is None:
        return shuffled_indices_numpy(n, seed)
    out = np.empty(n, dtype=np.int64)
    lib.shuffled_indices(n, ctypes.c_uint64(seed),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def gather_rows(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of ``data`` as a contiguous float64 array (the
    fallback: numpy indexing)."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= data.shape[0]):
        raise IndexError(f"gather_rows: indices outside [0, "
                         f"{data.shape[0]})")
    lib = get_lib()
    if lib is None:
        return data[idx]
    out = np.empty((idx.shape[0], data.shape[1]), dtype=np.float64)
    lib.gather_rows(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), data.shape[1],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


class MinibatchStream:
    """Epoch-shuffled minibatches over host arrays, seeded and
    deterministic: the host-side data path for a dataset too large to keep
    on the device (otherwise ``fit`` gathers on the device)."""

    def __init__(self, X: np.ndarray, Y: np.ndarray, batch_size: int,
                 seed: int = 0):
        if X.shape[0] != Y.shape[0]:
            raise ValueError(f"X and Y rows differ: {X.shape[0]} vs "
                             f"{Y.shape[0]}")
        self.X = np.ascontiguousarray(X, dtype=np.float64)
        self.Y = np.ascontiguousarray(Y, dtype=np.float64)
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        self._pos = 0
        self._idx = shuffled_indices(X.shape[0], seed)

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self.X.shape[0]
        if self._pos + self.batch_size > n:
            self._epoch += 1
            self._idx = shuffled_indices(n, self.seed + self._epoch)
            self._pos = 0
        sl = self._idx[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return gather_rows(self.X, sl), gather_rows(self.Y, sl)


class PrefetchingLoader:
    """A worker thread keeps a bounded queue of ready minibatches (the
    batches of :class:`MinibatchStream` with the same seed), moved to
    ``device`` when one is given, so host batch preparation overlaps
    device work.  The library's gather releases the interpreter lock.
    Close it (or use it as a context manager) to stop the thread."""

    def __init__(self, X: np.ndarray, Y: np.ndarray, batch_size: int,
                 seed: int = 0, depth: int = 4, device=None):
        self._stream = MinibatchStream(X, Y, batch_size, seed)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = device
        self._stop = threading.Event()
        self._worker_exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                xb, yb = self._stream.next()
                if self._device is not None:
                    xb = torch.as_tensor(xb).to(self._device)
                    yb = torch.as_tensor(yb).to(self._device)
                while not self._stop.is_set():
                    try:
                        self._q.put((xb, yb), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced by next(), not lost
            self._worker_exc = e

    def next(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                if not self._thread.is_alive():
                    if self._worker_exc is not None:
                        raise RuntimeError(
                            "PrefetchingLoader worker died"
                        ) from self._worker_exc
                    raise StopIteration

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
