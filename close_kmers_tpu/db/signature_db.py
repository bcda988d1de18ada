"""Signature-kmer database as sorted dense arrays.

The reference stores the signature DB as an mmap'd open-addressed hash
table of 24-byte ``sig_kmer_t`` entries (/root/reference/kmer_image.h:11-23,
kmer_image.cc:41-107, probe kguts.cc:585-602).  Random linear-probe chains
do not map to batched gathers; the layout here is:

* ``lo``      int32[N]  — low LO_DIGITS-aa code of each kmer, sorted within bucket
* ``fi``      int32[N]  — function index
* ``oi``      int32[N]  — OTU index
* ``avg_off`` int32[N]  — average offset from protein end (u16 range)
* ``wt``      float32[N]— function weight
* ``bucket_start`` int32[HI_CARD+1] — CSR offsets: kmers whose high
  HI_DIGITS-aa code equals ``h`` live at rows [bucket_start[h], bucket_start[h+1]).

i.e. a two-level index keyed by (hi, lo) = (code // 20^LO_DIGITS,
code % 20^LO_DIGITS) — currently a 5/3 split (hi < 3.2M, lo < 8000), so
every device-side quantity is int32 and the probe kernel needs no 64-bit
arithmetic at all.  A probe gathers the bucket bounds then resolves the
bucket either by a wide-row vector compare (small buckets) or a
branchless binary search over at most max_bucket entries.

Interop: readers/writers for the reference's on-disk artifacts
(``final.kmers`` text, kguts.h:34; ``kmer.table.mem_map`` binary image;
``function.index``/``otu.index`` dense text indexes, kguts.cc:544-575).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..params import HI_CARD, KMER_IMAGE_VERSION, LO_CARD, MAX_ENCODED
from ..ops.encoder import encode_aa_kmer

_IMAGE_HEADER = struct.Struct("<QQq")  # num_sigs, entry_size, version (kmer_image.h:11-15)
_SIG_KMER_DTYPE = np.dtype([
    ("which_kmer", "<u8"),
    ("otu_index", "<i4"),
    ("avg_from_end", "<u2"),
    ("_pad", "<u2"),
    ("function_index", "<i4"),
    ("function_wt", "<f4"),
])  # 24 bytes, matching sig_kmer_t layout (kmer_image.h:17-23)
assert _SIG_KMER_DTYPE.itemsize == 24


class SignatureDB:
    """Sorted-array signature kmer database + function/otu name indexes."""

    def __init__(self, keys: np.ndarray, fi: np.ndarray, oi: np.ndarray,
                 avg_off: np.ndarray, wt: np.ndarray,
                 functions: list[str] | None = None,
                 otus: list[str] | None = None,
                 n_hi: int | None = None):
        """``n_hi``: hi-bucket span (default HI_CARD).  A shard of a
        range-sharded DB rebases its keys to a local hi window so every
        bucket-indexed device table scales with the shard's span, not
        the global 20^5 — required at 1e9-key scale where per-bucket
        rows over all of HI_CARD would dwarf the shard itself."""
        keys = np.asarray(keys, dtype=np.int64)
        if len(keys) == 0 or (np.diff(keys) > 0).all():
            order = slice(None)  # already strictly sorted (fast path)
        else:
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            if (np.diff(keys) == 0).any():
                raise ValueError("duplicate kmer keys in signature DB")
        self.keys = keys
        self.fi = np.asarray(fi, dtype=np.int32)[order]
        self.oi = np.asarray(oi, dtype=np.int32)[order]
        self.avg_off = np.asarray(avg_off, dtype=np.int32)[order]
        self.wt = np.asarray(wt, dtype=np.float32)[order]
        self.n_hi = int(n_hi) if n_hi is not None else HI_CARD
        self.hi = (keys // LO_CARD).astype(np.int32)
        self.lo = (keys % LO_CARD).astype(np.int32)
        counts = np.bincount(self.hi, minlength=self.n_hi)
        self.bucket_start = np.zeros(self.n_hi + 1, dtype=np.int32)
        np.cumsum(counts, out=self.bucket_start[1:])
        self.max_bucket = int(counts.max()) if len(keys) else 0
        self.functions: list[str] = functions or []
        self.otus: list[str] = otus or []

    def __len__(self) -> int:
        return len(self.keys)

    # -- host-side lookup (oracle support) ---------------------------------

    def lookup(self, code: int):
        """(fI, oI, avg_off, wt) or None — semantic equivalent of
        lookup_hash_entry (kguts.cc:585-602)."""
        if code > MAX_ENCODED:
            return None
        i = np.searchsorted(self.keys, code)
        if i < len(self.keys) and self.keys[i] == code:
            return (int(self.fi[i]), int(self.oi[i]), int(self.avg_off[i]),
                    float(self.wt[i]))
        return None

    def function_of(self, i: int) -> str:
        if i < 0 or i >= len(self.functions):
            return "INVALID_OFFSET"
        return self.functions[i]

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_entries(cls, entries, functions=None, otus=None) -> "SignatureDB":
        """entries: iterable of (kmer_str_or_code, avg_off, fI, wt, oI).
        Entries whose kmer contains invalid characters are skipped, like
        KmerGuts::insert_kmer (kguts.cc:202-210)."""
        keys, offs, fis, wts, ois = [], [], [], [], []
        for kmer, avg_off, fI, wt, oI in entries:
            code = encode_aa_kmer(kmer) if isinstance(kmer, (str, bytes)) else int(kmer)
            if code > MAX_ENCODED:
                continue
            keys.append(code)
            offs.append(avg_off)
            fis.append(fI)
            wts.append(wt)
            ois.append(oI)
        return cls(np.array(keys, dtype=np.int64),
                   np.array(fis, dtype=np.int32),
                   np.array(ois, dtype=np.int32),
                   np.array(offs, dtype=np.int32),
                   np.array(wts, dtype=np.float32),
                   functions, otus)

    @classmethod
    def load_final_kmers(cls, path: str, functions=None, otus=None) -> "SignatureDB":
        """Parse the reference's text DB ``final.kmers``:
        ``kmer \\t avg_off \\t fI \\t weight \\t oI`` (kguts.cc:637-638,
        build_signature_kmers.cc:1363-1372).  A missing trailing oI column
        is tolerated (the reference's fscanf accepts >= 4 fields) and read
        as -1."""
        entries = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4:
                    continue
                kmer = parts[0]
                avg_off = int(parts[1])
                fI = int(parts[2])
                wt = float(parts[3])
                oI = int(parts[4]) if len(parts) > 4 else -1
                entries.append((kmer, avg_off, fI, wt, oI))
        return cls.from_entries(entries, functions, otus)

    @classmethod
    def load_mem_map(cls, path: str, functions=None, otus=None) -> "SignatureDB":
        """Read the reference's binary hash image (kmer.table.mem_map):
        header + open-addressed table whose empty slots have
        which_kmer > MAX_ENCODED (kmer_image.cc:41-107, kguts.cc:628-629)."""
        with open(path, "rb") as f:
            hdr = f.read(_IMAGE_HEADER.size)
            num_sigs, entry_size, version = _IMAGE_HEADER.unpack(hdr)
            if version != KMER_IMAGE_VERSION:
                raise ValueError(f"bad image version {version}")
            if entry_size != _SIG_KMER_DTYPE.itemsize:
                raise ValueError(f"bad entry size {entry_size}")
            table = np.fromfile(f, dtype=_SIG_KMER_DTYPE, count=num_sigs)
        mask = table["which_kmer"] <= MAX_ENCODED
        t = table[mask]
        return cls(t["which_kmer"].astype(np.int64),
                   t["function_index"].astype(np.int32),
                   t["otu_index"].astype(np.int32),
                   t["avg_from_end"].astype(np.int32),
                   t["function_wt"].astype(np.float32),
                   functions, otus)

    @classmethod
    def load_dir(cls, data_dir: str) -> "SignatureDB":
        """Load a reference-format data directory: kmer.table.mem_map (or
        final.kmers) + function.index + otu.index, mirroring
        KmerGuts::init_kmers (kguts.cc:659-679)."""
        functions = load_index_file(os.path.join(data_dir, "function.index"))
        otu_path = os.path.join(data_dir, "otu.index")
        otus = load_index_file(otu_path) if os.path.exists(otu_path) else []
        npz = os.path.join(data_dir, "signature_db.npz")
        mm = os.path.join(data_dir, "kmer.table.mem_map")
        fk = os.path.join(data_dir, "final.kmers")
        if os.path.exists(npz):
            return cls.load_npz(npz, functions, otus)
        if os.path.exists(mm):
            return cls.load_mem_map(mm, functions, otus)
        return cls.load_final_kmers(fk, functions, otus)

    # -- writers ------------------------------------------------------------

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, keys=self.keys, fi=self.fi, oi=self.oi,
                            avg_off=self.avg_off, wt=self.wt)

    @classmethod
    def load_npz(cls, path: str, functions=None, otus=None) -> "SignatureDB":
        z = np.load(path)
        return cls(z["keys"], z["fi"], z["oi"], z["avg_off"], z["wt"],
                   functions, otus)

    def save_mem_map(self, path: str, num_buckets: int | None = None) -> None:
        """Write a reference-compatible binary hash image using the same
        linear-probe insertion (find_empty_hash_entry, kguts.cc:166-171)
        so the file is byte-usable by the reference server."""
        n = len(self.keys)
        if num_buckets is None:
            num_buckets = _first_prime_over(3 * n)
        if n >= num_buckets // 2:
            raise ValueError("hash would be over half-full (kguts.cc:213-215)")
        table = np.zeros(num_buckets, dtype=_SIG_KMER_DTYPE)
        table["which_kmer"] = MAX_ENCODED + 1
        for i in range(n):
            h = int(self.keys[i]) % num_buckets
            while table["which_kmer"][h] <= MAX_ENCODED:
                h = (h + 1) % num_buckets
            table["which_kmer"][h] = self.keys[i]
            table["otu_index"][h] = self.oi[i]
            table["avg_from_end"][h] = self.avg_off[i]
            table["function_index"][h] = self.fi[i]
            table["function_wt"][h] = self.wt[i]
        with open(path, "wb") as f:
            f.write(_IMAGE_HEADER.pack(num_buckets, _SIG_KMER_DTYPE.itemsize,
                                       KMER_IMAGE_VERSION))
            table.tofile(f)

    def save_final_kmers(self, path: str) -> None:
        from ..ops.encoder import decode_kmer
        with open(path, "w") as f:
            for i in range(len(self.keys)):
                f.write(f"{decode_kmer(int(self.keys[i]))}\t{int(self.avg_off[i])}\t"
                        f"{int(self.fi[i])}\t{float(self.wt[i]):0.5f}\t{int(self.oi[i])}\n")


# The reference builder's hash sizing ladder: first prime > 3*n
# (build_signature_kmers.cc:862-878).  Used only for mem_map export.
_PRIME_LADDER = [
    3769, 6337, 12791, 24571, 51043, 101533, 206933, 400187,
    821999, 2000003, 4000037, 8000009, 16000057, 32000011,
    64000031, 128000003, 248000009, 508000037, 1073741824,
    1400303159, 2147483648, 1190492993, 3559786523, 6461346257,
]


def _first_prime_over(n: int) -> int:
    for p in _PRIME_LADDER:
        if p > n:
            return p
    raise ValueError(f"no ladder entry for {n}")


def load_index_file(path: str) -> list[str]:
    """Dense ``idx \\t name`` text index (function.index / otu.index),
    mirroring load_indexed_ar's density check (kguts.cc:544-575)."""
    out: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            idx_s, _, name = line.partition("\t")
            idx = int(idx_s)
            if idx != len(out):
                raise ValueError(f"index file {path} not dense at {idx}")
            out.append(name)
    return out


def write_index_file(path: str, names: list[str]) -> None:
    with open(path, "w") as f:
        for i, name in enumerate(names):
            f.write(f"{i}\t{name}\n")
