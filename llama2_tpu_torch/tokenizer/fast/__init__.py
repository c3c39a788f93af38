"""ctypes wrapper for the native C++ BPE tokenizer.

Port of ``llama2_tpu/tokenizer/fast/``: ``tokenizer.cpp`` is the same source,
compiled at first use by ``g++ -O2 -std=c++17 -shared -fPIC`` into
``build/tokenizer/`` at the repository root, the library named by a hash of
the source and the flags (as ``ops/cuda/build.py`` names the kernels'), so a
changed source is rebuilt. :class:`FastTokenizer` has the Python
:class:`~llama2_tpu_torch.tokenizer.tokenizer.Tokenizer`'s interface and
exact semantics. A build failure raises; :func:`load_tokenizer` never falls
back to the Python tokenizer (callers that want it name it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from llama2_tpu_torch.tokenizer.tokenizer import BOS, Tokenizer

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tokenizer.cpp")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(_REPO, "build", "tokenizer")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


class TokenizerBuildError(RuntimeError):
    pass


def lib_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"tokenizer-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-pid temp name + rename: another process may build the same
    # library, and dlopen of a half-written one aborts
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], capture_output=True)
    except OSError as e:
        raise TokenizerBuildError(f"cannot run g++ to build the tokenizer: {e}") from e
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise TokenizerBuildError(f"g++ failed for tokenizer.cpp:\n{r.stderr.decode(errors='replace')}")
    os.replace(tmp, so)


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = lib_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int32
        lib.l2t_create.restype = p
        lib.l2t_create.argtypes = [ctypes.c_char_p, i]
        lib.l2t_destroy.argtypes = [p]
        lib.l2t_max_token_len.restype = i
        lib.l2t_max_token_len.argtypes = [p]
        lib.l2t_vocab_size.restype = i
        lib.l2t_vocab_size.argtypes = [p]
        lib.l2t_token.restype = i
        lib.l2t_token.argtypes = [p, ctypes.c_uint32, ctypes.c_char_p, i]
        lib.l2t_lookup.restype = i
        lib.l2t_lookup.argtypes = [p, ctypes.c_char_p, i]
        lib.l2t_encode.restype = i
        lib.l2t_encode.argtypes = [p, ctypes.c_char_p, i, ctypes.POINTER(ctypes.c_uint32), i]
        _lib = lib
        return lib


class FastTokenizer:
    """Native tokenizer with the Python Tokenizer's interface and semantics."""

    def __init__(self, path: str, vocab_size: int):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.l2t_create(path.encode(), vocab_size)
        if not self._h:
            raise FileNotFoundError(f"cannot load tokenizer file: {path}")
        self.max_token_len = lib.l2t_max_token_len(self._h)
        self.vocab_size = lib.l2t_vocab_size(self._h)
        # token texts for the decode path (its framing rules are the Python tokenizer's)
        buf = ctypes.create_string_buffer(max(self.max_token_len, 1) * 2 + 8)
        self.tokens: list[bytes] = []
        for i in range(self.vocab_size):
            n = lib.l2t_token(self._h, i, buf, len(buf))
            self.tokens.append(buf.raw[:n])

    @classmethod
    def from_file(cls, path: str, vocab_size: int) -> "FastTokenizer":
        return cls(path, vocab_size)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.l2t_destroy(h)
            self._h = None

    def lookup(self, piece: bytes | str) -> int | None:
        if isinstance(piece, str):
            piece = piece.encode("utf-8")
        r = self._lib.l2t_lookup(self._h, piece, len(piece))
        return None if r < 0 else r

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        cap = max(len(data), 1)
        out = (ctypes.c_uint32 * cap)()
        n = self._lib.l2t_encode(self._h, data, len(data), out, cap)
        if n == -1:
            raise ValueError("token not found for codepoint in input")
        if n == -3:
            raise ValueError("invalid UTF-8 in input")
        if n < 0:
            raise RuntimeError(f"fast tokenizer error {n}")
        return list(out[:n])

    def decode_token(self, prev_token: int, token: int) -> bytes:
        return Tokenizer.decode_token(self, prev_token, token)  # type: ignore[arg-type]

    def decode(self, ids, first_prev: int = BOS) -> bytes:
        return Tokenizer.decode(self, ids, first_prev)  # type: ignore[arg-type]


def load_tokenizer(path: str, vocab_size: int) -> FastTokenizer:
    """The C++ tokenizer for ``path``, built first if needed; a failed build
    raises :class:`TokenizerBuildError`."""
    return FastTokenizer(path, vocab_size)
