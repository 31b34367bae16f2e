"""ctypes binding for the native BPE merge loop (a copy of
``ergm_tpu/tokenizer/native.py`` with its own build).

Loads ``ergm_tpu_torch/_build/libbpe_core.so``, built at first use from
the repository's ``cpp/bpe_core.cpp`` with ``g++ -O3 -std=c++17 -fPIC
-shared`` (the flags of ``cpp/Makefile``) into the port's git-ignored
build directory; ``ergm_tpu``'s ``ergm_tpu/_native/`` is left alone.
Where no C++ compiler is found or the build fails, ``NativeBPE.available``
is False and ``tokenizer/bpe.py`` runs its Python merge loop. That is a
tokenizer path, not a device or kernel path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE.parent / "cpp" / "bpe_core.cpp"
LIB_PATH = _PACKAGE / "_build" / "libbpe_core.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_load_attempted = False


def build() -> pathlib.Path:
    """Compile ``cpp/bpe_core.cpp`` into ``LIB_PATH`` (atomically: a
    process building at the same time never sees half a file). Raises
    without a compiler or on a failed build."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or c++)")
    LIB_PATH.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def _load_library():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not LIB_PATH.exists():
        try:
            build()
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bpe_new.restype = ctypes.c_void_p
    lib.bpe_new.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    lib.bpe_apply.restype = ctypes.c_int32
    lib.bpe_apply.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.bpe_apply_batch.restype = ctypes.c_int32
    lib.bpe_apply_batch.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int32,
                                    i32p, ctypes.c_int32, i32p]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bpe_set_byte_table.restype = None
    lib.bpe_set_byte_table.argtypes = [ctypes.c_void_p, i32p]
    lib.bpe_encode_bytes_batch.restype = ctypes.c_int32
    lib.bpe_encode_bytes_batch.argtypes = [ctypes.c_void_p, u8p, i32p,
                                           ctypes.c_int32, i32p, ctypes.c_int32, i32p]
    lib.bpe_free.restype = None
    lib.bpe_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBPE:
    """Id-space BPE merger. Built from a vocab + merge list where every
    merge's left/right/result strings are vocab entries."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.available = False
        self._handle = None
        lib = _load_library()
        if lib is None:
            return
        left, right, merged = [], [], []
        for a, b in merges:
            if a in vocab and b in vocab and (a + b) in vocab:
                left.append(vocab[a])
                right.append(vocab[b])
                merged.append(vocab[a + b])
        self._lib = lib
        la = np.asarray(left, np.int32)
        ra = np.asarray(right, np.int32)
        ma = np.asarray(merged, np.int32)
        self._handle = lib.bpe_new(len(la), _as_i32p(la), _as_i32p(ra), _as_i32p(ma))
        self.available = self._handle is not None
        self._has_byte_table = False
        if self.available:
            from ergm_tpu_torch.tokenizer.bpe import bytes_to_unicode

            byte_enc = bytes_to_unicode()
            table = np.full(256, -1, np.int32)
            complete = True
            for b in range(256):
                vid = vocab.get(byte_enc[b])
                if vid is None:
                    complete = False
                    break
                table[b] = vid
            if complete:
                lib.bpe_set_byte_table(self._handle, _as_i32p(table))
                self._has_byte_table = True

    def apply_word(self, sym_ids: Sequence[int]) -> List[int]:
        n = len(sym_ids)
        syms = np.asarray(sym_ids, np.int32)
        cap = max(n, 1)
        out = np.empty(cap, np.int32)
        got = self._lib.bpe_apply(self._handle, _as_i32p(syms), n, _as_i32p(out), cap)
        if got < 0:
            out = np.empty(-got, np.int32)
            got = self._lib.bpe_apply(self._handle, _as_i32p(syms), n, _as_i32p(out), -got)
        return out[:got].tolist()

    def apply_words(self, words: Sequence[Sequence[int]]) -> List[List[int]]:
        if not words:
            return []
        offsets = np.zeros(len(words) + 1, np.int32)
        for i, w in enumerate(words):
            offsets[i + 1] = offsets[i] + len(w)
        flat = np.asarray([s for w in words for s in w], np.int32)
        cap = int(offsets[-1]) or 1
        out = np.empty(cap, np.int32)
        counts = np.empty(len(words), np.int32)
        total = self._lib.bpe_apply_batch(self._handle, _as_i32p(flat), _as_i32p(offsets),
                                          len(words), _as_i32p(out), cap, _as_i32p(counts))
        if total < 0:
            raise RuntimeError("native BPE output overflow (cannot happen: merges shrink)")
        res, pos = [], 0
        for c in counts:
            res.append(out[pos:pos + int(c)].tolist())
            pos += int(c)
        return res

    def encode_word_bytes(self, words: Sequence[bytes]) -> List[List[int]]:
        """Encode pre-tokenized words from raw UTF-8 bytes — byte mapping
        and merges both native. Requires the full byte alphabet in vocab."""
        if not self._has_byte_table:
            raise RuntimeError("native byte table unavailable")
        if not words:
            return []
        offsets = np.zeros(len(words) + 1, np.int32)
        for i, w in enumerate(words):
            offsets[i + 1] = offsets[i] + len(w)
        blob = np.frombuffer(b"".join(words), np.uint8) if offsets[-1] else np.zeros(1, np.uint8)
        cap = max(int(offsets[-1]), 1)
        out = np.empty(cap, np.int32)
        counts = np.empty(len(words), np.int32)
        total = self._lib.bpe_encode_bytes_batch(
            self._handle, blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _as_i32p(offsets), len(words), _as_i32p(out), cap, _as_i32p(counts))
        if total < 0:
            raise RuntimeError(f"native byte-batch encode failed ({total})")
        res, pos = [], 0
        for c in counts:
            res.append(out[pos:pos + int(c)].tolist())
            pos += int(c)
        return res

    @property
    def has_byte_table(self) -> bool:
        return self._has_byte_table

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            try:
                self._lib.bpe_free(self._handle)
            except Exception:
                pass
