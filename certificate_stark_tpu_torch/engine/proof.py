"""STARK proof container + byte serialization (a copy of
certificate_stark_tpu/engine/proof.py: the same bytes for the same proof).

The reference's `StarkProof` is winterfell's serialized struct; ours is a
self-describing container with a deterministic byte encoding (proof size is a
tracked metric; see bench.py). Field elements serialize as 8-byte LE standard
form, matching the reference's element encoding (rescue.rs:179-186).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class QueryOpening:
    index: int
    trace_row: list          # trace_width ints (base field)
    h_row: list              # k * ext ints
    trace_path: list         # list of digest tuples
    h_path: list
    fri_openings: list       # per layer: (coset_values: list, path: list)


@dataclass
class Proof:
    trace_width: int
    trace_length: int
    options: object
    pub_inputs: list
    trace_root: tuple = ()
    h_root: tuple = ()
    ood_trace_z: list = field(default_factory=list)     # ext coeff lists
    ood_trace_zg: list = field(default_factory=list)
    ood_h: list = field(default_factory=list)
    fri_roots: list = field(default_factory=list)
    fri_remainder: list = field(default_factory=list)   # ext evals of last layer
    pow_nonce: int = 0
    queries: list = field(default_factory=list)

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        out = bytearray()

        def w_u32(v):
            out.extend(struct.pack("<I", int(v)))

        def w_felt(v):
            out.extend(int(v).to_bytes(8, "little"))

        def w_felts(vs):
            w_u32(len(vs))
            for v in vs:
                if isinstance(v, (list, tuple)):
                    for c in v:
                        w_felt(c)
                else:
                    w_felt(v)

        def w_digest(d):
            for x in d:
                w_felt(x)

        def w_path(path):
            w_u32(len(path))
            for d in path:
                w_digest(d)

        w_u32(self.trace_width)
        w_u32(self.trace_length)
        opts = self.options
        for v in (opts.num_queries, opts.blowup, opts.grinding_bits,
                  {"rescue": 0, "sha256": 1, "blake3": 2,
                   "sha3": 3}[opts.hash_fn],
                  opts.extension_degree, opts.fri_folding,
                  opts.fri_max_remainder):
            w_u32(v)
        w_felts(self.pub_inputs)
        w_digest(self.trace_root)
        w_digest(self.h_root)
        for grp in (self.ood_trace_z, self.ood_trace_zg, self.ood_h):
            w_felts(grp)
        w_u32(len(self.fri_roots))
        for r in self.fri_roots:
            w_digest(r)
        w_felts(self.fri_remainder)
        w_u32(self.pow_nonce)
        w_u32(len(self.queries))
        for q in self.queries:
            w_u32(q.index)
            w_felts(q.trace_row)
            w_felts(q.h_row)
            w_path(q.trace_path)
            w_path(q.h_path)
            w_u32(len(q.fri_openings))
            for vals, path in q.fri_openings:
                w_felts(vals)
                w_path(path)
        return bytes(out)

    def size_bytes(self) -> int:
        return len(self.to_bytes())

    def security_level(self, conjectured: bool = True) -> int:
        """Estimated security in bits (counterpart of winterfell's
        `StarkProof::security_level`, printed by the reference example CLI).

        Conjectured: queries * log2(blowup) + grinding, capped by the
        field+extension size and the commitment hash (Rescue commitment
        digests are truncated to 4 elements like the reference's
        Digest::as_bytes, rescue.rs:202-211 -> 4*63/2 = 126 collision bits;
        sha/blake 256-bit digests -> 128).
        """
        import math
        opts = self.options
        field_bits = 63 * opts.extension_degree - math.ceil(
            math.log2(self.trace_length * opts.blowup))
        query_bits = opts.num_queries * int(math.log2(opts.blowup)) \
            + opts.grinding_bits
        hash_bits = 126 if opts.hash_fn == "rescue" else 128
        return max(0, min(field_bits, query_bits, hash_bits))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        """Inverse of to_bytes (winterfell's StarkProof is Deserializable;
        this keeps proofs portable across processes/hosts)."""
        from .options import ProofOptions
        off = [0]

        def r_u32():
            v = struct.unpack_from("<I", data, off[0])[0]
            off[0] += 4
            return v

        def r_felt():
            v = int.from_bytes(data[off[0]:off[0] + 8], "little")
            off[0] += 8
            return v

        def r_felts():
            return [r_felt() for _ in range(r_u32())]

        def r_digest(dl):
            return tuple(r_felt() for _ in range(dl))

        def r_path(dl):
            return [r_digest(dl) for _ in range(r_u32())]

        tw, tl = r_u32(), r_u32()
        q, b, g, h, e, f, rem = (r_u32() for _ in range(7))
        opts = ProofOptions(num_queries=q, blowup=b, grinding_bits=g,
                            hash_fn=["rescue", "sha256", "blake3", "sha3"][h],
                            extension_degree=e, fri_folding=f,
                            fri_max_remainder=rem)
        # digest lengths match engine/hasher.py digest_len (rescue commitment
        # digests are TRUNCATED to 4 elements — ops/rescue.merge4)
        dl = {"rescue": 4, "sha256": 8, "blake3": 8, "sha3": 8}[opts.hash_fn]
        p = cls(trace_width=tw, trace_length=tl, options=opts,
                pub_inputs=r_felts())
        p.trace_root = r_digest(dl)
        p.h_root = r_digest(dl)
        p.ood_trace_z = r_felts()
        p.ood_trace_zg = r_felts()
        p.ood_h = r_felts()
        p.fri_roots = [r_digest(dl) for _ in range(r_u32())]
        p.fri_remainder = r_felts()
        p.pow_nonce = r_u32()
        nq = r_u32()
        for _ in range(nq):
            qo = QueryOpening(index=r_u32(), trace_row=r_felts(),
                              h_row=r_felts(), trace_path=r_path(dl),
                              h_path=r_path(dl), fri_openings=[])
            for _ in range(r_u32()):
                vals = r_felts()
                qo.fri_openings.append((vals, r_path(dl)))
            p.queries.append(qo)
        assert off[0] == len(data), "trailing bytes in proof"
        return p
