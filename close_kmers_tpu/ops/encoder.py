"""Amino-acid 8-mer encoding, vectorized.

Parity with the reference KmerEncoder (/root/reference/kmer_encoder.h:14-85,
kguts.cc:273-339):

* alphabet ``ACDEFGHIKLMNPQRSTVWY`` maps to offsets 0..19 (uppercase ONLY —
  the reference's ``to_amino_acid_off`` switch has no lowercase cases, so
  lowercase letters are "invalid" = offset 20);
* an 8-mer encodes positionally base-20:
  ``code = sum(off[i] * 20**(7-i))``;
* any window containing an invalid character encodes to the sentinel
  ``MAX_ENCODED + 1``.

The device representation avoids 64-bit integers entirely: a code is
carried as the pair ``(hi, lo) = (code // 20**LO_DIGITS,
code % 20**LO_DIGITS)`` (currently a 5/3 split: hi < 3.2M, lo < 8000),
both int32-safe.  This drives the two-level sorted index in
:mod:`close_kmers_tpu.db.signature_db`.
"""

from __future__ import annotations

import numpy as np

from ..params import HI_DIGITS, K, LO_CARD, LO_DIGITS, MAX_ENCODED

PROT_ALPHA = "ACDEFGHIKLMNPQRSTVWY"

# 256-entry lookup: byte -> amino-acid offset, invalid=20
# (kmer_encoder.cc:7-13).
AA_TO_OFFSET = np.full(256, 20, dtype=np.uint8)
for _i, _c in enumerate(PROT_ALPHA):
    AA_TO_OFFSET[ord(_c)] = _i

_POW20 = np.array([20 ** (K - 1 - i) for i in range(K)], dtype=np.int64)
_POW20_HI = np.array([20 ** (HI_DIGITS - 1 - i) for i in range(HI_DIGITS)], dtype=np.int64)
_POW20_LO = np.array([20 ** (LO_DIGITS - 1 - i) for i in range(LO_DIGITS)], dtype=np.int64)


def seq_to_offsets(seq: str | bytes) -> np.ndarray:
    """Protein string -> uint8 offsets (invalid chars = 20).

    Mirrors the per-character loop in KmerGuts::process_aa_seq
    (kguts.cc:901-902).
    """
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return AA_TO_OFFSET[raw]


def encode_aa_kmer(kmer: str | bytes) -> int:
    """Encode one K-length amino-acid string; returns MAX_ENCODED+1 if it
    contains an invalid character (kmer_encoder.h:37-50)."""
    off = seq_to_offsets(kmer)
    if len(off) != K:
        raise ValueError(f"kmer must be length {K}")
    if (off >= 20).any():
        return MAX_ENCODED + 1
    return int((off.astype(np.int64) * _POW20).sum())


def raw_keys_to_encoded(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized builder-key conversion: uint64 raw-byte kmer keys (8
    latin-1 chars big-endian, db/builder.py) -> (base-20 encoded int64
    codes, valid mask).  Invalid characters (incl. lowercase) make the
    whole kmer invalid, like insert_kmer via encoded_aa_kmer
    (kguts.cc:194-200, kmer_encoder.h:37-50).  For all-valid keys the
    raw-byte lexicographic order equals the encoded numeric order
    (PROT_ALPHA is alphabetically ascending)."""
    raw = np.asarray(raw, dtype=np.uint64)
    code = np.zeros(len(raw), dtype=np.int64)
    valid = np.ones(len(raw), dtype=bool)
    for i in range(K):
        byte = ((raw >> np.uint64(8 * (K - 1 - i))) & np.uint64(0xFF))
        off = AA_TO_OFFSET[byte.astype(np.int64)]
        valid &= off < 20
        code = code * 20 + off
    return code, valid


def decode_kmer(code: int) -> str:
    """Inverse of encode for valid codes (kmer_encoder.h:70-80)."""
    out = []
    x = int(code)
    for _ in range(K):
        out.append(PROT_ALPHA[x % 20])
        x //= 20
    return "".join(reversed(out))


def split_hi_lo(code: int) -> tuple[int, int]:
    """64-bit kmer code -> (hi, lo) int32 pair."""
    return int(code) // LO_CARD, int(code) % LO_CARD


def join_hi_lo(hi, lo):
    """(hi, lo) -> 64-bit code (host-side only; device code never joins)."""
    return np.asarray(hi, dtype=np.int64) * LO_CARD + np.asarray(lo, dtype=np.int64)


def windows_valid(offsets: np.ndarray) -> np.ndarray:
    """Boolean mask over window start positions [0, len-K] marking windows
    whose K characters are all valid.

    NOTE the reference scans only positions p < len-K — the final window
    at len-K is never probed (gather_hits bound, kguts.cc:792,798).  That
    exclusion is applied by callers via :func:`num_scanned_positions`, not
    here.
    """
    valid = offsets < 20
    n = len(offsets) - K + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    out = np.ones(n, dtype=bool)
    for j in range(K):
        out &= valid[j : j + n]
    return out


def num_scanned_positions(seq_len: int) -> int:
    """Number of window start positions the reference engine scans:
    positions p with p < seq_len - K (kguts.cc:792-798), i.e. the last
    full window is excluded."""
    return max(0, seq_len - K)


def encode_windows_hi_lo(offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized window encoding (host-side numpy mirror of the device op).

    Returns (hi, lo, valid) arrays over the *scanned* positions
    [0, len-K) — matching the reference's exclusive bound.  Invalid
    windows get hi=lo=-1.
    """
    n = num_scanned_positions(len(offsets))
    if n <= 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy(), np.zeros(0, dtype=bool)
    off64 = offsets.astype(np.int64)
    hi = np.zeros(n, dtype=np.int64)
    lo = np.zeros(n, dtype=np.int64)
    for j in range(HI_DIGITS):
        hi += off64[j : j + n] * _POW20_HI[j]
    for j in range(LO_DIGITS):
        lo += off64[HI_DIGITS + j : HI_DIGITS + j + n] * _POW20_LO[j]
    valid = windows_valid(offsets)[:n]
    hi = np.where(valid, hi, -1).astype(np.int32)
    lo = np.where(valid, lo, -1).astype(np.int32)
    return hi, lo, valid
