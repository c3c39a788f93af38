"""``tokenizer.bin`` BPE tokenizer with the reference's exact semantics.

File format (parsed by the reference at main.zig:182-196): ``u32 LE
max_token_len``, then per token: ``f32 LE score``, ``u32 LE byte_len``,
``byte_len`` raw bytes. Vocab size comes from the *model* header, not the file.

Encode contract (main.zig:219-282):
  * split input into UTF-8 codepoints; exact-lookup each one's UTF-8 bytes —
    an unknown codepoint is an error (**no** ``<0xXX>`` byte-fallback; this is
    a deliberate divergence from llama2.c, main.zig:240-242);
  * repeatedly merge the adjacent pair whose concatenation exists in vocab with
    the highest score; on ties the *lowest pair index* wins because the scan
    uses strict ``>`` (main.zig:260-266);
  * no BOS/EOS and no leading-space "dummy prefix" are added.

Decode/printing contract (main.zig:1021-1034, 1055-1076): if the *previous*
token was BOS(1) and the next token's text begins with a space, strip that
space; a token of the literal 6-char form ``<0xXX>`` decodes to one raw byte,
emitted **only if** ASCII-printable or whitespace — otherwise the literal
6-char string is emitted.

Where the reference linear-scans the 32k vocab per lookup (main.zig:208-215,
O(n^2 * V) encode), this implementation uses a bytes->id hash map built with
first-occurrence-wins semantics, which preserves the linear scan's
first-match behavior for duplicate token strings while being O(1) per lookup.
A copy of ``llama2_tpu/tokenizer/tokenizer.py``; the entry points load the
C++ encoder of the same semantics (``tokenizer/fast/``).
"""

from __future__ import annotations

import struct

BOS = 1
EOS = 2

_ASCII_WHITESPACE = frozenset(b" \t\n\r\x0b\x0c")


def decode_raw_byte(token_bytes: bytes) -> int | None:
    """Match the literal 6-char ``<0xXX>`` pattern (main.zig:1055-1076).

    Returns the byte value if the pattern matches AND the byte is ASCII
    printable or whitespace; otherwise None (caller emits the literal string).
    """
    if len(token_bytes) != 6:
        return None
    if token_bytes[0:3] != b"<0x" or token_bytes[5:6] != b">":
        return None
    try:
        byte = int(token_bytes[3:5], 16)
    except ValueError:
        return None
    # std.ascii.isPrint (0x20..0x7E) or std.ascii.isWhitespace
    if 0x20 <= byte <= 0x7E or byte in _ASCII_WHITESPACE:
        return byte
    return None


class Tokenizer:
    """Vocabulary + greedy-merge BPE encoder + streaming decoder."""

    def __init__(self, tokens: list[bytes], scores: list[float], max_token_len: int):
        self.tokens = tokens
        self.scores = scores
        self.max_token_len = max_token_len
        # First occurrence wins, matching the reference's linear scan.
        self._index: dict[bytes, int] = {}
        for i, tok in enumerate(tokens):
            self._index.setdefault(tok, i)

    @classmethod
    def from_file(cls, path: str, vocab_size: int) -> "Tokenizer":
        with open(path, "rb") as f:
            data = f.read()
        (max_token_len,) = struct.unpack_from("<I", data, 0)
        off = 4
        tokens: list[bytes] = []
        scores: list[float] = []
        for _ in range(vocab_size):
            score, blen = struct.unpack_from("<fI", data, off)
            off += 8
            tokens.append(data[off : off + blen])
            off += blen
            scores.append(score)
        return cls(tokens, scores, max_token_len)

    def lookup(self, piece: bytes | str) -> int | None:
        if isinstance(piece, str):
            piece = piece.encode("utf-8")
        return self._index.get(piece)

    def encode(self, text: str) -> list[int]:
        """Greedy highest-score merge encode (contract in module docstring)."""
        ids: list[int] = []
        for ch in text:  # Python iterates str by codepoint, same as utf8Decode
            tid = self._index.get(ch.encode("utf-8"))
            if tid is None:
                raise ValueError(f"token not found for codepoint {ch!r}")
            ids.append(tid)

        tokens = self.tokens
        scores = self.scores
        index = self._index
        while len(ids) > 1:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for i in range(len(ids) - 1):
                cat = tokens[ids[i]] + tokens[ids[i + 1]]
                tid = index.get(cat)
                if tid is not None and scores[tid] > best_score:
                    best_score = scores[tid]
                    best_id = tid
                    best_idx = i
            if best_idx < 0:
                break
            ids[best_idx : best_idx + 2] = [best_id]
        return ids

    def decode_token(self, prev_token: int, token: int) -> bytes:
        """Render one token as output bytes with the reference's framing rules."""
        text = self.tokens[token]
        if prev_token == BOS and text.startswith(b" "):
            text = text[1:]
        byte = decode_raw_byte(text)
        if byte is not None:
            return bytes([byte])
        return text

    def decode(self, ids: list[int], first_prev: int = BOS) -> bytes:
        """Render a token sequence the way the generation loop prints it."""
        out = bytearray()
        prev = first_prev
        for t in ids:
            out += self.decode_token(prev, t)
            prev = t
        return bytes(out)
