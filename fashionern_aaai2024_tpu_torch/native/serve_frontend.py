"""ctypes binding and device loop of the native serving front
(`fastserve.cpp`).

JAX counterpart: `fashionern_aaai2024_tpu/native/serve_frontend.py`.
Division of labour:

  C++ IO thread (GIL-free): accept -> HTTP parse -> JSON parse -> BPE
      tokenize (the port's `fasttokenizer.cpp`) -> name -> row lookup ->
      micro-batch queue
  Python device thread:     fs_next_batch (blocks with the GIL released)
      -> one call of the service's serve program (one CUDA graph replay
      on the card) -> fs_complete_batch
  C++ (inside that call):   per-item top-k JSON formatting -> epoll
      writeback

Usage:
    ns = serve_native(service, host="0.0.0.0", port=8080)
    ... ns.port, ns.wait(), ns.shutdown()

Endpoints served natively: POST /query (single and client batch), GET
/healthz, GET /stats. /add and /reload answer 501: they live on the
Python server of a second (admin) port; after a live add the service's
`names_changed_cb` pushes the grown name table into the C++ front with
one `fs_set_names` swap.

Build: `g++` at first use into `build/native/<hash>/` (`native/build.py`,
the hash covering the included tokenizer source). Where the JAX binding
reports a failed build and leaves the caller to the Python server, this
one raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from fashionern_aaai2024_tpu_torch.native.build import NativeLibrary

MAX_CAPTION = 64 * 1024  # kMaxCaption in fastserve.cpp


def _bind(lib: ctypes.CDLL) -> None:
    i32, i64, vp, cp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    lib.fs_create.restype = vp
    lib.fs_create.argtypes = [cp, vp, i32, cp, i64, i32, i32, i32, i64]
    lib.fs_set_names.restype = None
    lib.fs_set_names.argtypes = [vp, cp, vp, i32]
    lib.fs_listen.restype = i32
    lib.fs_listen.argtypes = [vp, cp, i32]
    lib.fs_next_batch.restype = i64
    lib.fs_next_batch.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp, vp]
    lib.fs_complete_batch.restype = None
    lib.fs_complete_batch.argtypes = [vp, i64, vp, vp, i32, i32]
    lib.fs_fail_batch.restype = None
    lib.fs_fail_batch.argtypes = [vp, i64, cp]
    lib.fs_port.restype = i32
    lib.fs_port.argtypes = [vp]
    lib.fs_shutdown.restype = None
    lib.fs_shutdown.argtypes = [vp]
    lib.fs_destroy.restype = None
    lib.fs_destroy.argtypes = [vp]


_HERE = Path(__file__).resolve().parent
LIBRARY = NativeLibrary(_HERE / "fastserve.cpp", "libfastserve.so",
                        [("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")], _bind,
                        includes=[_HERE / "fasttokenizer.cpp"])


def _pack_names(names) -> tuple[bytes, np.ndarray, int]:
    encoded = [str(n).encode("utf-8") for n in names]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets, len(encoded)


class NativeFrontend:
    """One fastserve server: the epoll HTTP front and its batch queue.

    `merges`: the BPE merge table (list of (str, str)): captions are
    tokenized on the C++ IO thread (the rows it flags by the Python
    tokenizer). None: every row is flagged, and the device loop tokenizes
    the whole batch through the service's tokenizer. The ids are the
    Python tokenizer's either way."""

    def __init__(self, names, ctx: int, max_batch: int = 32, k_max: int = 50, merges=None,
                 max_wait_ms: float = 2.0):
        lib = LIBRARY.load()
        self._lib = lib
        self.ctx = int(ctx)
        self.max_batch = int(max_batch)
        self.k_max = int(k_max)
        blob = b"" if merges is None else "\n".join(f"{a} {b}" for a, b in merges).encode()
        names_buf, offsets, n = _pack_names(names)
        self._h = lib.fs_create(names_buf, offsets.ctypes.data, n, blob if blob else None,
                                len(blob), self.ctx, self.max_batch, self.k_max,
                                int(max_wait_ms * 1e3))
        # the batch transfer buffers, reused (one device thread)
        self._ids = np.zeros((self.max_batch, self.ctx), np.int32)
        self._rows = np.zeros(self.max_batch, np.int32)
        self._ks = np.zeros(self.max_batch, np.int32)
        self._fallback = np.zeros(self.max_batch, np.int8)
        self._capbuf = np.empty(self.max_batch * MAX_CAPTION + 1, np.uint8)
        self._capoff = np.zeros(self.max_batch + 1, np.int64)
        self.port = 0

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        p = int(self._lib.fs_listen(self._h, host.encode(), int(port)))
        if p <= 0:
            raise OSError(f"fastserve: failed to bind {host}:{port}")
        self.port = p
        return p

    def set_names(self, names) -> None:
        names_buf, offsets, n = _pack_names(names)
        self._lib.fs_set_names(self._h, names_buf, offsets.ctypes.data, n)

    def next_batch(self):
        """Block (GIL released) until a batch is ready: (batch_id, ids
        [n, ctx], rows [n], ks [n], fallback mask [n], captions), or None
        at shutdown. The arrays are views of the reused buffers: consume
        them before the next call."""
        out_n = ctypes.c_int32(0)
        bid = self._lib.fs_next_batch(
            self._h, self._ids.ctypes.data, self._rows.ctypes.data, self._ks.ctypes.data,
            self._fallback.ctypes.data, self._capbuf.ctypes.data, self._capbuf.size,
            self._capoff.ctypes.data, ctypes.byref(out_n))
        if bid == 0:
            return None
        n = out_n.value
        caps = [self._capbuf[self._capoff[i]:self._capoff[i + 1]].tobytes()
                .decode("utf-8", errors="replace") for i in range(n)]
        return (int(bid), self._ids[:n], self._rows[:n], self._ks[:n],
                self._fallback[:n] != 0, caps)

    def complete(self, batch_id: int, scores: np.ndarray, idx: np.ndarray,
                 k_used: int) -> None:
        scores = np.ascontiguousarray(scores, np.float32)
        idx = np.ascontiguousarray(idx, np.int32)
        self._lib.fs_complete_batch(self._h, int(batch_id), scores.ctypes.data,
                                    idx.ctypes.data, scores.shape[0], int(k_used))

    def fail(self, batch_id: int, message: str) -> None:
        self._lib.fs_fail_batch(self._h, int(batch_id),
                                message.encode("utf-8", errors="replace"))

    def shutdown(self) -> None:
        if self._h:
            self._lib.fs_shutdown(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.fs_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def _service_merges(service):
    """The merge table for tokenizing on the IO thread, or None when a
    Python step must run first (a caption transform, a tokenizer other
    than the port's BPE)."""
    if not getattr(service, "caption_join_is_identity", False):
        return None
    api = getattr(service, "api", None)
    if api is None:
        return None
    from fashionern_aaai2024_tpu_torch.models.clip import tokenizer as T

    tok = getattr(api, "_tokenizer", None)
    if tok is T.tokenize:
        tok = T._default_tokenizer()
    return tok._merges if isinstance(tok, T.SimpleTokenizer) else None


class NativeServer:
    """A running native front and its Python device-loop thread."""

    def __init__(self, frontend: NativeFrontend, service, thread: threading.Thread):
        self.frontend = frontend
        self.service = service
        self.port = frontend.port
        self._thread = thread

    def wait(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def shutdown(self) -> None:
        self.frontend.shutdown()
        self._thread.join(timeout=10)
        self.frontend.close()


def _device_loop(frontend: NativeFrontend, service) -> None:
    sf = service._serve_fn
    join = service.caption_join
    while True:
        nb = frontend.next_batch()
        if nb is None:
            return
        bid, ids, rows, ks, fb, caps = nb
        try:
            if fb.any():
                # the Python tokenizer for the rows the C core flags (every
                # row when the front has no merge table)
                sel = np.nonzero(fb)[0]
                ids[sel] = service.api.tokenize([join(caps[i]) for i in sel])
            k_used = int(min(max(int(ks.max()), 1), sf.k_max))
            scores, idx = sf(ids, rows, k=k_used)
            frontend.complete(bid, scores, idx, idx.shape[1])
        except Exception as e:  # the daemon keeps serving: every waiter gets a 500
            frontend.fail(bid, f"{type(e).__name__}: {e}")


def serve_native(service, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 2.0) -> NativeServer:
    """Start the native HTTP front over a RetrievalService and its
    device-loop thread; returns at once (a daemon thread)."""
    sf = service._serve_fn
    names = getattr(getattr(service, "gallery", None), "names", None)
    if names is None:
        raise ValueError("service has no gallery name table")
    frontend = NativeFrontend(names, ctx=service.api.context_length,
                              max_batch=max(sf.buckets), k_max=sf.k_max,
                              merges=_service_merges(service), max_wait_ms=max_wait_ms)
    frontend.listen(host, port)
    # live adds (the admin server) push the grown name table into the front
    service.names_changed_cb = lambda: frontend.set_names(service.gallery.names)
    t = threading.Thread(target=_device_loop, args=(frontend, service), daemon=True,
                         name="fastserve-device")
    t.start()
    return NativeServer(frontend, service, t)
