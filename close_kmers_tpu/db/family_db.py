"""Family databases: PATRIC global/local family metadata, kmer→family and
kmer→peg mappings, and family representative pegs.

Parity targets in /root/reference:

* KmerPegMapping — kmer.h:25-159, kmer.cc.  TBB concurrent hash maps
  become host-side dicts during load, finalized into CSR arrays (sorted
  int64 kmer keys + offsets + flat value list) for query-time lookups and
  for shipping to device.
* load_families — kmer.cc:358-508 (9-column families.dat: pgf/plf naming,
  genus mapping, per-family size/count rollup).
* load_genus_map — kmer.cc:338-355.
* add_fam_mapping — kmer.cc:244-268: per-kmer family list is DEDUPED,
  first-insertion order (fam_map_insert, kmer.cc:216-230).
* add_mapping (peg mode) — kmer.cc:174-214: NOT deduped.
* NR preload — nr_loader.cc:131-186: per NR protein, all signature-kmer
  hits map the kmer to the protein's family.
* FamilyReps — family_reps.cc:14-80.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class FamilyData:
    """family_data_t (kmer.h:58-68)."""
    pgf: str
    plf: str
    genus_id: int
    function: str
    family_id: int
    total_size: int
    count: int


class KmerFamilyMapping:
    """Host-side mapping database (KmerPegMapping analog).

    Pegs are interned to dense ids in first-seen order (assign_new_peg_id,
    kmer.h:111-118); families to dense ids in first-seen file order
    (kmer.cc:446-501, single-threaded here so deterministic).
    """

    def __init__(self) -> None:
        self.genus_map: dict[str, str] = {}
        self.families: list[FamilyData] = []
        self.family_key_to_id: dict[tuple[str, str], int] = {}
        self.peg_names: list[str] = []
        self.peg_to_id: dict[str, int] = {}
        self.peg_to_family: dict[int, int] = {}
        # build-phase maps; finalized into CSR
        self._kmer_to_fams: dict[int, list[int]] = {}
        self._kmer_to_pegs: dict[int, list[int]] = {}
        # Bulk kmer->family CSR from load_nr (keys i64 sorted unique,
        # offs i64, vals i32).  The dict above is the incremental /add
        # delta on top of it; fam_csr() merges the two.  Array-native
        # replacement for the NRLoader/KmerInserter insert machinery
        # (nr_loader.cc:160-183): the NR scan yields flat (code, fam)
        # arrays which sort/group directly — no per-hit dict work.
        self._bulk_fam = None
        self._fam_csr = None
        self._peg_csr = None
        self._meta_arrays = None
        # Bumped by any mutation of `families` (load_families); keys the
        # family_meta_arrays cache so in-place metadata edits or a
        # same-length reload can't serve stale interned arrays.
        self._families_gen = 0

    def family_meta_arrays(self):
        """Interned per-family metadata for the vectorized best-match scan
        (core.family.find_best_family_matches_batch): int32 arrays
        (func_id, pgf_id, genus_id) over family ids, the pgf/plf name
        lists those ids index, and the function-string intern dict.
        Cached; invalidated by the families generation counter."""
        F = len(self.families)
        gen = (self._families_gen, F)
        if self._meta_arrays is not None and self._meta_arrays[0] == gen:
            return self._meta_arrays[1]
        func_intern: dict[str, int] = {}
        pgf_intern: dict[str, int] = {}
        func_id = np.empty(F, dtype=np.int32)
        pgf_id = np.empty(F, dtype=np.int32)
        genus_id = np.empty(F, dtype=np.int32)
        plf_names = []
        for i, fd in enumerate(self.families):
            func_id[i] = func_intern.setdefault(fd.function, len(func_intern))
            pgf_id[i] = pgf_intern.setdefault(fd.pgf, len(pgf_intern))
            genus_id[i] = fd.genus_id
            plf_names.append(fd.plf)
        pgf_names = list(pgf_intern)
        out = (func_id, pgf_id, genus_id, pgf_names, plf_names, func_intern)
        self._meta_arrays = (gen, out)
        return out

    # -- id interning -------------------------------------------------------

    def encode_peg(self, peg: str) -> int:
        pid = self.peg_to_id.get(peg)
        if pid is None:
            pid = len(self.peg_names)
            self.peg_to_id[peg] = pid
            self.peg_names.append(peg)
        return pid

    def decode_peg(self, pid: int) -> str:
        return self.peg_names[pid]

    # -- loading ------------------------------------------------------------

    def load_genus_map(self, path: str) -> None:
        """genus \\t taxon-id lines (kmer.cc:338-355)."""
        with open(path) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) >= 2:
                    self.genus_map[cols[0]] = cols[1]

    def lookup_genus(self, genus: str) -> str:
        return self.genus_map.get(genus, "")

    def load_families(self, path: str) -> None:
        """PATRIC families.dat: 9 columns (kmer.cc:358-374).

        pgf = "PGF_" + col0[2:]; plf = "PLF_" + genus-taxon + "_" +
        zero-padded(col8, 8); unmapped genus falls back to the genus name
        itself with genus_id 0 (kmer.cc:423-444).
        """
        warned: set[str] = set()
        self._families_gen += 1
        with open(path) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 9:
                    continue
                pgf = "PGF_" + cols[0][2:]
                mapped = self.genus_map.get(cols[7])
                if mapped is None:
                    if cols[7] not in warned:
                        warned.add(cols[7])
                    plf_mid = cols[7]
                    genus_id = 0
                else:
                    plf_mid = mapped
                    genus_id = int(mapped)
                # zeros.substr(0, 8 - size) with size_t wraparound: a
                # >8-digit family number gets the FULL "00000000" prefix
                # (kmer.cc:379, 440-441), not zero padding.
                pad = "00000000" if len(cols[8]) > 8 \
                    else "0" * (8 - len(cols[8]))
                plf = "PLF_" + plf_mid + "_" + pad + cols[8]
                pid = self.encode_peg(cols[3])
                seqlen = int(cols[4])
                fkey = (pgf, plf)
                fam_id = self.family_key_to_id.get(fkey)
                if fam_id is None:
                    fam_id = len(self.families)
                    self.family_key_to_id[fkey] = fam_id
                    self.families.append(FamilyData(pgf, plf, genus_id, cols[5],
                                                    fam_id, seqlen, 1))
                else:
                    fd = self.families[fam_id]
                    fd.total_size += seqlen
                    fd.count += 1
                self.peg_to_family[pid] = fam_id

    # -- kmer mapping inserts ----------------------------------------------

    def add_fam_mapping(self, fam_id: int, kmer: int) -> None:
        """Deduped, insertion-ordered (kmer.cc:216-230,244-268).  The
        bulk CSR counts as already-present: /add of a pair the NR preload
        ingested is a no-op, like the reference's set-semantics map."""
        if self._bulk_fam is not None:
            keys, offs, vals = self._bulk_fam
            i = np.searchsorted(keys, kmer)
            if i < len(keys) and keys[i] == kmer \
                    and fam_id in vals[offs[i]:offs[i + 1]]:
                return
        lst = self._kmer_to_fams.get(kmer)
        if lst is None:
            self._kmer_to_fams[kmer] = [fam_id]
        elif fam_id not in lst:
            lst.append(fam_id)
        self._fam_csr = None

    def add_peg_mapping(self, peg_id: int, kmer: int) -> None:
        """NOT deduped (kmer.cc:174-214)."""
        self._kmer_to_pegs.setdefault(kmer, []).append(peg_id)
        self._peg_csr = None

    # Flush accumulated (code, fam) pairs into the bulk CSR once this many
    # pile up: keeps load_nr's peak host RAM O(threshold + CSR) instead of
    # O(total hits) for very large NR inputs (the reference's nr_loader
    # streams batches into the inserter queues, nr_loader.cc:160-183).
    NR_INGEST_PAIRS = 32_000_000

    def load_nr(self, nr_path: str, engine, batch_size: int = 4096) -> int:
        """Preload kmer→family mappings from a families NR FASTA
        (nr_loader.cc:131-186): for each protein with a known family,
        every signature-kmer hit maps that kmer to the family.

        Array-native: the engine's vectorized hit extraction
        (``hit_codes_of_batch``, falling back to hits_of_batch) yields
        flat (code, fam) pairs per batch; one global sort/dedup builds
        the bulk CSR — no per-hit Python, unlike the reference's
        per-pair concurrent-map inserts.  Returns proteins processed.
        """
        from ..io.fasta import parse_fasta_file

        seqs = list(parse_fasta_file(nr_path))
        n_done = 0
        code_parts: list[np.ndarray] = []
        fam_parts: list[np.ndarray] = []
        get_codes = getattr(engine, "hit_codes_of_batch", None)
        for i in range(0, len(seqs), batch_size):
            chunk = seqs[i:i + batch_size]
            if get_codes is not None:
                row_off, codes = get_codes([s for _, _, s in chunk])
            else:
                hit_lists = engine.hits_of_batch([s for _, _, s in chunk])
                row_off = np.zeros(len(chunk) + 1, dtype=np.int64)
                np.cumsum([len(h) for h in hit_lists], out=row_off[1:])
                codes = np.array([h.code for hits in hit_lists
                                  for h in hits], dtype=np.int64)
            fams = np.full(len(chunk), -1, dtype=np.int32)
            for j, (sid, _, _) in enumerate(chunk):
                fam_id = self.peg_to_family.get(self.encode_peg(sid))
                if fam_id is None:
                    continue      # NO FAM FOR id (nr_loader.cc:152-158)
                fams[j] = fam_id
                n_done += 1
            per_seq = np.diff(row_off)
            fam_per_hit = np.repeat(fams, per_seq)
            keep = fam_per_hit >= 0
            code_parts.append(codes[keep])
            fam_parts.append(fam_per_hit[keep])
            if sum(len(c) for c in code_parts) >= self.NR_INGEST_PAIRS:
                self._ingest_bulk_fam(np.concatenate(code_parts),
                                      np.concatenate(fam_parts))
                code_parts, fam_parts = [], []
        self._ingest_bulk_fam(np.concatenate(code_parts) if code_parts
                              else np.zeros(0, np.int64),
                              np.concatenate(fam_parts) if fam_parts
                              else np.zeros(0, np.int32))
        return n_done

    def _ingest_bulk_fam(self, codes: np.ndarray, fams: np.ndarray) -> None:
        """Merge flat (code, fam) pairs into the bulk CSR: dedup keeps
        the FIRST occurrence and within-kmer family order is by first
        occurrence (matching add_fam_mapping's insertion-order list)."""
        if self._bulk_fam is not None:
            bk, bo, bv = self._bulk_fam
            codes = np.concatenate([np.repeat(bk, np.diff(bo)), codes])
            fams = np.concatenate([bv, fams.astype(np.int32)])
        if len(codes) == 0:
            return
        occ = np.arange(len(codes), dtype=np.int64)
        order = np.lexsort((occ, fams, codes))
        first = np.ones(len(order), dtype=bool)
        cs, fs = codes[order], fams[order]
        first[1:] = (cs[1:] != cs[:-1]) | (fs[1:] != fs[:-1])
        kept = order[first]
        kept.sort()                      # back to first-occurrence order
        codes, fams = codes[kept], fams[kept]
        order = np.lexsort((np.arange(len(codes)), codes))  # stable group
        codes, fams = codes[order], fams[order]
        new_key = np.ones(len(codes), dtype=bool)
        new_key[1:] = codes[1:] != codes[:-1]
        keys = codes[new_key]
        offs = np.zeros(len(keys) + 1, dtype=np.int64)
        offs[1:] = np.cumsum(np.bincount(
            np.cumsum(new_key) - 1, minlength=len(keys)))
        self._bulk_fam = (keys, offs, fams.astype(np.int32))
        self._fam_csr = None

    # -- CSR finalization & lookup ------------------------------------------

    @staticmethod
    def _to_csr(d: dict[int, list[int]]):
        keys = np.array(sorted(d.keys()), dtype=np.int64)
        offs = np.zeros(len(keys) + 1, dtype=np.int64)
        vals_list = []
        for i, k in enumerate(keys):
            v = d[int(k)]
            vals_list.append(np.asarray(v, dtype=np.int32))
            offs[i + 1] = offs[i] + len(v)
        vals = (np.concatenate(vals_list) if vals_list
                else np.zeros(0, dtype=np.int32))
        return keys, offs, vals

    def fam_csr(self):
        if self._fam_csr is None:
            delta = self._to_csr(self._kmer_to_fams)
            if self._bulk_fam is None:
                self._fam_csr = delta
            elif len(delta[0]) == 0:
                self._fam_csr = self._bulk_fam
            else:
                bk, bo, bv = self._bulk_fam
                dk, do, dv = delta
                codes = np.concatenate([np.repeat(bk, np.diff(bo)),
                                        np.repeat(dk, np.diff(do))])
                fams = np.concatenate([bv, dv])
                # stable by code: bulk entries precede delta appends
                order = np.lexsort((np.arange(len(codes)), codes))
                codes, fams = codes[order], fams[order]
                # Dedup (code, fam) pairs: a pair /add'ed before load_nr
                # ingested the same pair exists in BOTH the delta and the
                # bulk CSR (add_fam_mapping's guard only sees an existing
                # bulk), and a duplicate would inflate rollup counts vs
                # the reference's set semantics (kmer.cc:216-230).  Keep
                # the first occurrence in merged (bulk-first) order.
                occ = np.arange(len(codes), dtype=np.int64)
                o2 = np.lexsort((occ, fams, codes))
                dup = np.zeros(len(o2), dtype=bool)
                dup[1:] = ((codes[o2][1:] == codes[o2][:-1])
                           & (fams[o2][1:] == fams[o2][:-1]))
                keep = np.ones(len(codes), dtype=bool)
                keep[o2[dup]] = False
                codes, fams = codes[keep], fams[keep]
                new_key = np.ones(len(codes), dtype=bool)
                new_key[1:] = codes[1:] != codes[:-1]
                keys = codes[new_key]
                offs = np.zeros(len(keys) + 1, dtype=np.int64)
                offs[1:] = np.cumsum(np.bincount(
                    np.cumsum(new_key) - 1, minlength=len(keys)))
                self._fam_csr = (keys, offs, fams)
        return self._fam_csr

    def peg_csr(self):
        if self._peg_csr is None:
            self._peg_csr = self._to_csr(self._kmer_to_pegs)
        return self._peg_csr

    def families_of_kmer(self, kmer: int) -> list[int]:
        out: list[int] = []
        if self._bulk_fam is not None:
            keys, offs, vals = self._bulk_fam
            i = int(np.searchsorted(keys, kmer))
            if i < len(keys) and keys[i] == kmer:
                out = [int(v) for v in vals[offs[i]:offs[i + 1]]]
        lst = self._kmer_to_fams.get(kmer)
        if lst is None:
            return out
        # same bulk-first set semantics as fam_csr: a pair /add'ed before
        # the NR ingest landed it in the bulk CSR must not appear twice
        return out + [f for f in lst if f not in out]

    def pegs_of_kmer(self, kmer: int) -> list[int]:
        lst = self._kmer_to_pegs.get(kmer)
        return lst if lst is not None else []

    def write_kmer_distribution(self, os_) -> None:
        """--kmer-family-distribution-file debug dump
        (kmer.cc:526-545): ``kmer \\t code \\t n_families`` per kmer,
        plus ``pgf plf function`` columns when exactly one family."""
        from ..ops.encoder import decode_kmer

        keys, offs, vals = self.fam_csr()
        for i in range(len(keys)):
            code = int(keys[i])
            fams = vals[offs[i]:offs[i + 1]]
            os_.write(f"{decode_kmer(code)}\t{code}\t{len(fams)}")
            if len(fams) == 1:
                fd = self.families[int(fams[0])]
                os_.write(f"\t{fd.pgf}\t{fd.plf}\t{fd.function}")
            os_.write("\n")

    def dump_sizes(self) -> str:
        """/dump_sizes debug endpoint content (kmer.cc:510-524 analog)."""
        lines = [
            f"kmer_to_id_: size={len(self._kmer_to_pegs)}",
            f"kmer_to_id_: content size={sum(len(v) for v in self._kmer_to_pegs.values())}",
            f"peg_to_id_: size={len(self.peg_to_id)}",
            f"kmer_to_family_id_: size={len(self.fam_csr()[0])}",
            f"family_data_: size={len(self.families)}",
        ]
        return "\n".join(lines) + "\n"


@dataclasses.dataclass
class RepData:
    """family_reps.h:28-38."""
    feature_id: str
    contig: str
    contig_length: int
    start: int
    end: int
    strand: str


class FamilyReps:
    """Local-family representative pegs (family_reps.cc)."""

    def __init__(self) -> None:
        self.reps: dict[str, list[RepData]] = {}

    def load_reps_file(self, path: str) -> None:
        """TSV with header; columns per family_reps.cc:44-49:
        col3 = local family id (key), col2 = feature, col5 = contig,
        col6 = start, col7 = end, col8 = strand, col9 = contig length."""
        with open(path) as f:
            f.readline()  # header
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 10:
                    continue
                try:
                    self.reps.setdefault(cols[3], []).append(RepData(
                        feature_id=cols[2], contig=cols[5],
                        contig_length=int(cols[9]) if cols[9] else 0,
                        start=int(cols[6]), end=int(cols[7]),
                        strand=cols[8][0] if cols[8] else " "))
                except ValueError:
                    # reference aborts the whole file on stoul errors
                    # (family_reps.cc:52-55); we skip the line.
                    continue

    def load_reps_directory(self, path: str) -> None:
        for name in sorted(os.listdir(path)):
            self.load_reps_file(os.path.join(path, name))
