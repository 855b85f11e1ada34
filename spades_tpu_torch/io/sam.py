"""Minimal SAM read/write support.

Capability mirror of the reference's SAM surface
(SPAdes `src/common/io/sam/` sam_reader/sam_parser, used by the
post-assembly corrector to consume BWA-MEM alignments,
`projects/corrector/dataset_processor.cpp`): parse alignment records with
enough fidelity for per-position variant counting (QNAME/FLAG/RNAME/POS/
MAPQ/CIGAR/SEQ), and write mappings produced by our own mapper as SAM so
downstream tools can consume them.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int        # 1-based leftmost mapping position (0 if unmapped)
    mapq: int
    cigar: str
    seq: str
    tags: dict

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    def cigar_ops(self) -> list[tuple[int, str]]:
        return [(int(n), op) for n, op in _CIGAR_RE.findall(self.cigar)]

    def aligned_pairs(self) -> list[tuple[int, int]]:
        """(read_pos, ref_pos) for every aligned (M/=/X) base — the walk the
        corrector's per-position counter performs."""
        out = []
        rp = 0
        gp = self.pos - 1
        for n, op in self.cigar_ops():
            if op in "M=X":
                out.extend((rp + i, gp + i) for i in range(n))
                rp += n
                gp += n
            elif op in "IS":
                rp += n
            elif op in "DN":
                gp += n
        return out


def _parse_sam_lines(fh) -> Iterator[SamRecord]:
    for line in fh:
        if line.startswith("@") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        if len(f) < 11:
            continue
        tags = {}
        for tag in f[11:]:
            parts = tag.split(":", 2)
            if len(parts) == 3:
                tags[parts[0]] = parts[2]
        yield SamRecord(
            qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
            mapq=int(f[4]), cigar=f[5], seq=f[9], tags=tags,
        )


def read_sam(path: str) -> Iterator[SamRecord]:
    """Iterate alignment records; header lines are skipped."""
    with open(path) as fh:
        yield from _parse_sam_lines(fh)


def write_sam(path: str, references: list[tuple[str, int]], records: list[SamRecord]) -> None:
    """Write a SAM file with @HD/@SQ headers and the given records."""
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:unknown\n")
        for name, length in references:
            fh.write(f"@SQ\tSN:{name}\tLN:{length}\n")
        for r in records:
            tags = "".join(
                f"\t{k}:{'i' if isinstance(v, int) else 'Z'}:{v}" for k, v in r.tags.items()
            )
            fh.write(
                f"{r.qname}\t{r.flag}\t{r.rname}\t{r.pos}\t{r.mapq}\t"
                f"{r.cigar}\t*\t0\t0\t{r.seq}\t*{tags}\n"
            )


def mappings_to_sam(
    path: str, g, names: list[str], seqs: list[str], mappings
) -> int:
    """Dump our mapper's dominant-anchor mappings (`alignment.mapper
    .ReadMapping`) as ungapped SAM records against edge references."""
    refs = [(str(int(e)), int(g.e_len[e])) for e in g.canonical_edge_ids()]
    records = []
    n = 0
    for name, seq, m in zip(names, seqs, mappings):
        if m is None:
            records.append(SamRecord(name, 4, "*", 0, 0, "*", seq, {}))
            continue
        e = m.edge
        conj = int(g.e_conj[e])
        # canonical reference is min(e, conj); reverse-strand hit flags 0x10
        if e <= conj:
            rname, flag = str(e), 0
            pos = m.start_offset + 1
        else:
            rname, flag = str(conj), 16
            pos = int(g.e_len[conj]) - (m.start_offset + len(seq)) + 1
        clip_left = max(0, 1 - pos)
        pos = max(pos, 1)
        aligned = min(len(seq) - clip_left, int(g.e_len[int(rname)]) - (pos - 1))
        if aligned <= 0:
            records.append(SamRecord(name, 4, "*", 0, 0, "*", seq, {}))
            continue
        cigar = ""
        if clip_left:
            cigar += f"{clip_left}S"
        cigar += f"{aligned}M"
        rest = len(seq) - clip_left - aligned
        if rest > 0:
            cigar += f"{rest}S"
        records.append(
            SamRecord(name, flag, rname, pos, 60, cigar, seq, {"NH": 1})
        )
        n += 1
    write_sam(path, refs, records)
    return n


# ---------------------------------------------------------------------------
# BAM support: BGZF-compressed binary SAM (reference reads BAM through its
# SAM layer, SPAdes `src/common/io/sam/bam_parser.cpp:1` + vendored
# bamtools).  BGZF blocks are standard gzip members with an extra field, so
# Python's gzip reader (which handles concatenated members) inflates them;
# records decode into the same SamRecord model the text parser yields.
# ---------------------------------------------------------------------------

_BAM_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_BAM_CIGAR_OPS = "MIDNSHP=X"


def _decode_bam_records(data: bytes) -> Iterator[SamRecord]:
    import struct

    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream (bad magic)")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs: list[str] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        refs.append(data[off : off + l_name - 1].decode())
        off += l_name + 4  # skip trailing NUL already excluded + l_ref
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p : p + l_read_name - 1].decode()
        p += l_read_name
        cigar_parts = []
        for _ in range(n_cigar):
            (cv,) = struct.unpack_from("<I", data, p)
            cigar_parts.append(f"{cv >> 4}{_BAM_CIGAR_OPS[cv & 0xF]}")
            p += 4
        nybbles = data[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        chars = []
        for i in range(l_seq):
            b = nybbles[i // 2]
            code = (b >> 4) if i % 2 == 0 else (b & 0xF)
            chars.append(_BAM_SEQ_CODES[code])
        seq = "".join(chars)
        # qual + tags skipped (corrector/binspreader use pos/flag/cigar/seq)
        off = end
        yield SamRecord(
            qname=qname, flag=flag,
            rname=refs[ref_id] if 0 <= ref_id < len(refs) else "*",
            pos=pos + 1 if pos >= 0 else 0, mapq=mapq,
            cigar="".join(cigar_parts) or "*", seq=seq or "*", tags={},
        )


def read_bam(path: str) -> Iterator[SamRecord]:
    """Iterate alignment records of a BAM file (BGZF or plain-gzip)."""
    import gzip

    with gzip.open(path, "rb") as fh:
        data = fh.read()
    yield from _decode_bam_records(data)


def write_bam(path: str, references: list[tuple[str, int]],
              records: list[SamRecord]) -> None:
    """Write records as BAM (single gzip member — readable by `read_bam`
    and any BGZF-tolerant reader; this writer exists for round-trips and
    tool interop tests, the product writer remains SAM text)."""
    import gzip
    import struct

    out = bytearray()
    text = "@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in references
    )
    out += b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
    out += struct.pack("<i", len(references))
    for nme, ln in references:
        nb = nme.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    ref_ids = {n: i for i, (n, _) in enumerate(references)}
    rev_codes = {c: i for i, c in enumerate(_BAM_SEQ_CODES)}
    for r in records:
        ops = r.cigar_ops() if r.cigar != "*" else []
        seq = "" if r.seq == "*" else r.seq
        nyb = bytearray((len(seq) + 1) // 2)
        for i, c in enumerate(seq):
            code = rev_codes.get(c.upper(), 15)
            nyb[i // 2] |= code << 4 if i % 2 == 0 else code
        body = struct.pack(
            "<iiBBHHHiiii",
            ref_ids.get(r.rname, -1), r.pos - 1 if r.pos > 0 else -1,
            len(r.qname) + 1, r.mapq, 0, len(ops), r.flag, len(seq),
            -1, -1, 0,
        )
        body += r.qname.encode() + b"\x00"
        for cnt, op in ops:
            body += struct.pack("<I", (cnt << 4) | _BAM_CIGAR_OPS.index(op))
        body += bytes(nyb)
        body += b"\xff" * len(seq)  # quals absent
        out += struct.pack("<i", len(body)) + body
    with gzip.open(path, "wb") as fh:
        fh.write(bytes(out))


def read_alignments(path: str) -> Iterator[SamRecord]:
    """Dispatch SAM text vs BAM by content, not extension — the corrector's
    --sam input and binspreader alignments accept plain SAM, BAM, and
    gzipped SAM text (.sam.gz): a gzip member is only BAM if the INFLATED
    stream starts with the BAM magic."""
    import gzip

    with open(path, "rb") as fh:
        head = fh.read(4)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as fh:
            inner = fh.read(4)
        if inner == b"BAM\x01":
            yield from read_bam(path)
        else:
            with gzip.open(path, "rt") as fh:
                yield from _parse_sam_lines(fh)
    else:
        yield from read_sam(path)
