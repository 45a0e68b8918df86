"""'regenerating' plugin — product-matrix regenerating codes (arXiv
1412.3022 lineage; construction of Rashmi-Shah-Kumar).

Repair-optimal codec family for the recovery/backfill hot path: where a
classic RS code repairs ONE lost shard by reading k whole chunks and
re-encoding, a product-matrix regenerating code repairs it by reading a
β-sub-chunk *contribution* from each of d helper shards — repair
bandwidth ~d·β·L instead of k·α·L (docs/RECOVERY.md has the math).

Two techniques behind one construction:

- ``pm_mbr`` (default, any k <= d <= n-1): minimum-bandwidth
  regenerating.  α = d sub-chunks per shard, β = 1, message size
  B = k·d − k(k−1)/2 sub-chunks.  Message matrix M (d×d, symmetric)
  = [[S, T], [Tᵗ, 0]] with S (k×k) symmetric and T (k×(d−k)); shard i
  stores Ψ_i·M.  Repair of shard f moves exactly d sub-chunks — ONE
  shard's worth of bytes — regardless of k.
- ``pm_msr`` (d = 2(k−1)): minimum-storage regenerating (MDS rate).
  α = k−1, B = k·α; M (2α×α) = [[S1], [S2]] with S1, S2 symmetric.
  Repair moves d·β = d sub-chunks = d·chunk/(d−k+1) bytes.

Ψ (n×d) is Vandermonde over GF(2^8) on evaluation points chosen so the
λ_i = x_i^α are pairwise distinct (the MSR pairwise decode inverts
[[1,λ_i],[1,λ_j]]); any d rows of Ψ and any α rows of Φ = Ψ[:, :α] are
then independent by the Vandermonde argument, which is the whole
correctness requirement of the construction.

Execution: encode, the ≥d-survivor decode and the repair solve are plain
GF(2^8) matrix multiplies, so they ride the existing device machinery —
a ``DeviceRSBackend`` built on [[I_d], [Ψ]] runs them as launches of the
GF(2^8) bit-matmul kernel (K1) on ``backend=cuda`` and as its plain
PyTorch version on ``backend=host``, and the dispatch scheduler
coalesces signature-equal encodes (own ``pm-regen`` family — never
grouped with RS-matrix codes).  The below-d structured decode is host
numpy (MUL_TABLE math), as in the JAX package.  The code is NOT
systematic (no shard stores raw object bytes — the defining trade of the
product-matrix family), so the codec flags ``requires_whole_object_rw``
and the EC backend routes ranged reads and rmw through whole-object
cycles.

Port of ``ceph_tpu/ec/regenerating.py`` without its fault guard, circuit
breaker and host fallback (``run_device_call``, ``_note_cpu_fallback``):
a device error propagates to the caller.  The JAX mesh hooks
(``g_mesh.decode_stacked``) become the port's mesh switch
(``dispatch/batch.py``): 0 or 1 chips is the single device, 2 or more
raises until the port has a mesh (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ..common.kernel_trace import g_kernel_timer
from ..gf.matrices import gf_invert_matrix
from ..gf.tables import MUL_TABLE, gf_pow
from .matrix_plugin import ErasureCodeMatrixRS
from .rs_codec import MatrixRSCodec, gf_matvec_bytes

DEFAULT_K = 4
DEFAULT_M = 2
# sub-chunk unit (bytes) when the profile doesn't pin one; chunk
# geometry is α·unit per stripe, stripe width B·unit (docs/RECOVERY.md)
DEFAULT_SUBCHUNK_UNIT = 512


def _select_points(n: int, alpha: int) -> List[int]:
    """n evaluation points x_i in GF(256)* whose α-th powers are
    pairwise distinct (λ_i = x_i^α must differ for the MSR pairwise
    solve; the α-th power map is 255/gcd(α,255)-to-one, so a greedy
    scan suffices for any practical n)."""
    pts: List[int] = []
    seen = set()
    v = 1
    while len(pts) < n and v < 256:
        lam = gf_pow(v, max(alpha, 1))
        if lam not in seen:
            pts.append(v)
            seen.add(lam)
        v += 1
    if len(pts) < n:
        raise ValueError(
            f"cannot place n={n} nodes with distinct lambda over "
            f"GF(256) at alpha={alpha}")
    return pts


class ErasureCodeRegenerating(ErasureCodeMatrixRS):
    """Product-matrix MBR/MSR codec behind the ErasureCode ABI."""

    signature_family = "pm-regen"
    dispatch_batchable = True
    # all-output codec: encode_batch consumes prepared message matrices
    # and yields EVERY shard row (no systematic passthrough rows)
    dispatch_full_output = True
    # non-systematic: shard bytes are Ψ·M projections, so chunk-offset
    # arithmetic on logical offsets is meaningless — the EC backend
    # reads/rmws whole objects for this codec
    requires_whole_object_rw = True
    _device_decode_supported = True

    @property
    def mesh_row_shardable(self) -> bool:
        # the JAX mesh plan models the systematic coding-rows matmul;
        # the full-output Ψ projection doesn't fit it.  The fused
        # resident encode (ops/resident.py) reads the same flag, so a
        # regenerating pool never takes K5
        return False

    @property
    def mesh_decode_shardable(self) -> bool:
        # ...but the read side fits: the ≥d decode and the d×d repair
        # solve are plain inverted-survivor matmuls over [[I],[Ψ]] rows.
        # Kept with the JAX package's rule for the port's mesh
        return self._device_decode_supported

    def _single_device(self) -> None:
        """The port's mesh switch before a device solve (the JAX
        package's ``g_mesh.decode_stacked`` site): raises for a mesh of
        two or more chips on ``backend=cuda``."""
        if self._use_device():
            from ..dispatch.batch import _mesh_active
            _mesh_active()

    def __init__(self):
        super().__init__()
        self.technique = "pm_mbr"
        self.d = 0
        self.alpha = 0       # sub-chunks stored per shard
        self.beta = 1        # sub-chunks a helper contributes to repair
        self.B = 0           # message sub-chunks per stripe
        self.rows = 0        # message-matrix rows (= d)
        self.cols = 0        # message-matrix cols (= α)
        self.subchunk_unit = DEFAULT_SUBCHUNK_UNIT
        self.psi: np.ndarray = None          # (n, d) encoding matrix
        self._lambda: np.ndarray = None      # λ_i = Ψ[i, α]
        self._idx_map: np.ndarray = None     # (rows, cols) -> msg index
        self._take: np.ndarray = None
        self._zero_mask: np.ndarray = None

    # ---- profile ----------------------------------------------------------
    def init(self, profile) -> None:
        super().init(profile)
        self.k = self.to_int("k", profile, DEFAULT_K)
        self.m = self.to_int("m", profile, DEFAULT_M)
        self.sanity_check_k(self.k)
        n = self.k + self.m
        self.technique = profile.get("technique", "pm_mbr")
        if self.technique not in ("pm_mbr", "pm_msr"):
            raise ValueError(f"technique={self.technique} must be "
                             "pm_mbr or pm_msr")
        if self.technique == "pm_msr":
            default_d = 2 * (self.k - 1)
        else:
            default_d = min(n - 1, self.k + 2)
        self.d = self.to_int("d", profile, default_d)
        if self.technique == "pm_msr":
            if self.d != 2 * (self.k - 1):
                raise ValueError(
                    f"pm_msr requires d = 2(k-1) = {2 * (self.k - 1)}, "
                    f"got d={self.d}")
            self.alpha = self.k - 1
        else:
            if not (self.k <= self.d <= n - 1):
                raise ValueError(
                    f"pm_mbr requires k <= d <= n-1 "
                    f"({self.k} <= {self.d} <= {n - 1})")
            self.alpha = self.d
        if self.d > n - 1:
            raise ValueError(f"d={self.d} needs n-1={n - 1} helpers")
        self.subchunk_unit = self.to_int("subchunk", profile,
                                         self._default_unit())
        if self.subchunk_unit <= 0:
            raise ValueError("subchunk must be positive")
        if profile.get("mapping"):
            raise ValueError(
                "regenerating codes do not support mapping= layouts")
        if profile.get("stripe_unit"):
            # chunk geometry is codec-defined (stripe = B·subchunk);
            # silently ignoring an operator's stripe_unit would be a
            # no-op knob — reject it and point at the real one
            raise ValueError(
                "regenerating codes derive their stripe width from "
                "subchunk= (B x subchunk bytes); stripe_unit= does "
                "not apply")
        self._init_backend(profile)
        self._build_matrices()
        # host twin + device backend on the stacked [[I_d], [Ψ]] code:
        # MatrixRSCodec rows 0..d-1 are the message rows, d..d+n-1 the
        # stored shard rows — the existing decode machinery then covers
        # the ≥d-survivor row reconstruction for free
        full = np.vstack([np.eye(self.rows, dtype=np.uint8), self.psi])
        self.codec = MatrixRSCodec(full)
        self._profile.update({"k": str(self.k), "m": str(self.m),
                              "d": str(self.d),
                              "technique": self.technique})

    @staticmethod
    def _default_unit() -> int:
        from ..common.config import g_conf
        try:
            v = int(g_conf.get_val("ec_regen_subchunk_unit"))
        except Exception:
            v = 0
        return v or DEFAULT_SUBCHUNK_UNIT

    def _build_matrices(self) -> None:
        k, d, alpha = self.k, self.d, self.alpha
        n = k + self.m
        pts = _select_points(n, alpha)
        self.psi = np.array(
            [[gf_pow(x, j) for j in range(d)] for x in pts],
            dtype=np.uint8)
        self._lambda = np.array([gf_pow(x, alpha) for x in pts],
                                dtype=np.uint8)
        if self.technique == "pm_msr":
            rows, cols = 2 * alpha, alpha
            idx = np.full((rows, cols), -1, dtype=np.int64)
            c = 0
            for half in range(2):                 # S1 then S2
                base = half * alpha
                for i in range(alpha):
                    for j in range(i, alpha):
                        idx[base + i][j] = idx[base + j][i] = c
                        c += 1
        else:
            rows = cols = d
            idx = np.full((rows, cols), -1, dtype=np.int64)
            c = 0
            for i in range(k):                    # S (k×k symmetric)
                for j in range(i, k):
                    idx[i][j] = idx[j][i] = c
                    c += 1
            for i in range(k):                    # T / Tᵗ
                for j in range(k, d):
                    idx[i][j] = idx[j][i] = c
                    c += 1
        self.B = c
        self.rows, self.cols = rows, cols
        self._idx_map = idx
        self._take = np.maximum(idx, 0).ravel()
        self._zero_mask = (idx < 0).ravel()

    # ---- geometry ---------------------------------------------------------
    def codec_signature(self):
        return (self.signature_family, self.k, self.m, self.technique,
                self.d, self.subchunk_unit, ())

    def get_sub_chunk_count(self) -> int:
        return self.alpha

    def sub_chunk_bytes(self, object_size: int) -> int:
        """Sub-chunk width L for a standalone object: the message holds
        B sub-chunks, aligned like the matrix codecs' chunks."""
        alignment = self.get_alignment()
        L = (object_size + self.B - 1) // self.B
        rem = L % alignment
        if rem:
            L += alignment - rem
        return max(L, alignment)

    def get_chunk_size(self, object_size: int) -> int:
        return self.alpha * self.sub_chunk_bytes(object_size)

    def preferred_stripe_width(self) -> int:
        """Pool stripe width: one message (B sub-chunks) per stripe."""
        return self.B * self.subchunk_unit

    def make_stripe_info(self, stripe_width: int):
        """Codec-geometry stripe info for the EC backend: logical
        stripe = B·L bytes, stored chunk = α·L bytes (≠ width/k — the
        non-systematic trade)."""
        from ..osd.ecutil import stripe_info_t
        if stripe_width % self.B:
            raise ValueError(
                f"stripe width {stripe_width} is not a multiple of the "
                f"message size B={self.B}")
        L = stripe_width // self.B
        si = stripe_info_t.__new__(stripe_info_t)
        si.stripe_width = stripe_width
        si.chunk_size = self.alpha * L
        return si

    # ---- message-matrix assembly ------------------------------------------
    def _sub_l(self, chunk_size: int) -> int:
        assert chunk_size % self.cols == 0, \
            f"chunk {chunk_size} not a multiple of {self.cols} sub-chunks"
        return chunk_size // self.cols

    def regen_prepare_batch(self, payload, n_stripes: int) -> np.ndarray:
        """Flat payload (S·B·L bytes) -> batched message matrices
        (S, rows, cols·L) — the dispatcher's pre-matmul assembly hook
        (a host gather; the matmul that follows is columnwise
        independent, so bucket padding stays output-preserving)."""
        buf = payload if isinstance(payload, np.ndarray) \
            else np.frombuffer(bytes(payload), dtype=np.uint8)
        S = n_stripes
        L = len(buf) // (S * self.B)
        assert S * self.B * L == len(buf)
        data = buf.reshape(S, self.B, L)
        m = data[:, self._take, :]
        m[:, self._zero_mask, :] = 0
        return np.ascontiguousarray(
            m.reshape(S, self.rows, self.cols * L))

    def _message_to_rows(self, msg: np.ndarray, S: int,
                         L: int) -> np.ndarray:
        """Message blocks (B, S·L) -> M in shard-chunk byte order
        (rows, S·C) for row-reconstruction matvecs."""
        m = msg[self._take, :]
        m[self._zero_mask, :] = 0
        m = m.reshape(self.rows, self.cols, S, L)
        return np.ascontiguousarray(
            m.transpose(0, 2, 1, 3).reshape(self.rows,
                                            S * self.cols * L))

    # ---- encode -----------------------------------------------------------
    def encode_batch(self, m_batch: np.ndarray) -> np.ndarray:
        """Batched message matrices (S, rows, C) -> ALL shard chunks
        (S, n, C) in one Ψ projection (full-output contract; the
        dispatcher slices per-request rows/columns back out): one K1
        launch on the card.  Timed as ``ec_regen_encode_batch`` on the
        card and ``ec_regen_encode_batch_host`` for ``backend=host``,
        the JAX package's names for its two routes."""
        s, rows, c = m_batch.shape
        if rows != self.rows:
            raise ValueError(f"message matrices have {rows} rows, the "
                             f"code {self.rows}")
        name = "ec_regen_encode_batch" if self._use_device() \
            else "ec_regen_encode_batch_host"
        return g_kernel_timer.timed(name, self._device_encode_batch,
                                    np.ascontiguousarray(m_batch))

    def encode(self, want_to_encode: Set[int], data) -> Dict[int, np.ndarray]:
        from .base import as_chunk
        raw = as_chunk(data)
        L = self.sub_chunk_bytes(len(raw))
        padded = np.zeros(self.B * L, dtype=np.uint8)
        padded[:len(raw)] = raw
        allc = self.encode_batch(self.regen_prepare_batch(padded, 1))
        return {i: np.ascontiguousarray(allc[0, i, :])
                for i in want_to_encode}

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, np.ndarray]) -> None:
        raise NotImplementedError(
            "regenerating codes are whole-stripe: use encode()")

    # ---- decode -----------------------------------------------------------
    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """The repair API surface: a single-shard repair query (one
        wanted, missing shard with ≥d helpers up) answers with d helper
        shards at β=1 sub-chunks each — ~d·chunk/α bytes on the wire
        instead of k whole chunks.  Any other query follows the base
        any-k semantics (all shards are equivalent: the code has no
        systematic set)."""
        missing = set(want_to_read) - set(available)
        if len(want_to_read) == 1 and missing:
            helpers = sorted(set(available) - set(want_to_read))
            if len(helpers) >= self.d:
                return {h: [(0, self.beta)] for h in helpers[:self.d]}
        return super().minimum_to_decode(want_to_read, available)

    def _structured_message(self, chunks: Dict[int, np.ndarray]
                            ) -> Tuple[np.ndarray, int, int]:
        """Message blocks (B, S·L) from the first k available shard
        chunks — the below-d decode the product-matrix structure
        exists for.  Host reference path (pure MUL_TABLE math)."""
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise IOError(
                f"need at least k={self.k} chunks, have {len(avail)}")
        K = avail[:self.k]
        some = np.asarray(chunks[K[0]])
        S, C = (1, some.shape[0]) if some.ndim == 1 else some.shape
        L = self._sub_l(C)
        # (k, cols, S·L): sub-chunk blocks per selected shard row
        R = np.stack([
            np.ascontiguousarray(
                np.asarray(chunks[i], dtype=np.uint8)
                .reshape(S, self.cols, L).transpose(1, 0, 2))
            .reshape(self.cols, S * L)
            for i in K])
        msg = np.zeros((self.B, S * L), dtype=np.uint8)
        if self.technique == "pm_msr":
            self._decode_msr(K, R, msg)
        else:
            self._decode_mbr(K, R, msg)
        return msg, S, L

    def _decode_mbr(self, K: Sequence[int], R: np.ndarray,
                    msg: np.ndarray) -> None:
        k, d = self.k, self.d
        SL = R.shape[-1]
        phi = self.psi[list(K), :k]
        inv_phi = gf_invert_matrix(phi)
        C1 = R[:, :k, :]
        if d > k:
            delta = self.psi[list(K), k:d]
            C2 = R[:, k:, :]
            T = gf_matvec_bytes(
                inv_phi, np.ascontiguousarray(C2).reshape(
                    k, (d - k) * SL)).reshape(k, d - k, SL)
            Tt = np.ascontiguousarray(T.transpose(1, 0, 2))
            DTt = gf_matvec_bytes(
                delta, Tt.reshape(d - k, k * SL)).reshape(k, k, SL)
            C1 = C1 ^ DTt
        else:
            T = np.zeros((k, 0, SL), dtype=np.uint8)
        Smat = gf_matvec_bytes(
            inv_phi, np.ascontiguousarray(C1).reshape(
                k, k * SL)).reshape(k, k, SL)
        c = 0
        for i in range(k):
            for j in range(i, k):
                msg[c] = Smat[i, j]
                c += 1
        for i in range(k):
            for j in range(d - k):
                msg[c] = T[i, j]
                c += 1

    def _decode_msr(self, K: Sequence[int], R: np.ndarray,
                    msg: np.ndarray) -> None:
        k, alpha = self.k, self.alpha
        SL = R.shape[-1]
        phi = self.psi[list(K), :alpha]             # (k, α)
        lam = [int(self._lambda[i]) for i in K]
        # P[i,j] = Ψ_i M Φ_j^T: project each received row onto Φ_K
        P = np.stack([gf_matvec_bytes(phi, R[i]) for i in range(k)])
        A = np.zeros((k, k, SL), dtype=np.uint8)    # Φ_i S1 Φ_j^T
        Bm = np.zeros((k, k, SL), dtype=np.uint8)   # Φ_i S2 Φ_j^T
        from ..gf.tables import gf_inv
        for i in range(k):
            for j in range(i + 1, k):
                inv_l = gf_inv(lam[i] ^ lam[j])
                b = MUL_TABLE[inv_l][P[i, j] ^ P[j, i]]
                a = P[i, j] ^ MUL_TABLE[lam[i]][b]
                A[i, j] = A[j, i] = a
                Bm[i, j] = Bm[j, i] = b
        # row i's projections against the other k-1 = α+1... exactly α
        # rows pin v_i = Φ_i S: solve G_i v_i = a_i over the pair grid
        V1 = np.zeros((alpha, alpha * SL), dtype=np.uint8)
        V2 = np.zeros((alpha, alpha * SL), dtype=np.uint8)
        for ii in range(alpha):
            others = [j for j in range(k) if j != ii]
            inv_g = gf_invert_matrix(phi[others, :])
            V1[ii] = gf_matvec_bytes(
                inv_g, np.ascontiguousarray(A[ii][others])).reshape(-1)
            V2[ii] = gf_matvec_bytes(
                inv_g, np.ascontiguousarray(Bm[ii][others])).reshape(-1)
        inv_phi_a = gf_invert_matrix(phi[:alpha, :])
        S1 = gf_matvec_bytes(inv_phi_a, V1).reshape(alpha, alpha, SL)
        S2 = gf_matvec_bytes(inv_phi_a, V2).reshape(alpha, alpha, SL)
        c = 0
        for half in (S1, S2):
            for i in range(alpha):
                for j in range(i, alpha):
                    msg[c] = half[i, j]
                    c += 1

    def decode_payload_batch(self, chunks: Dict[int, np.ndarray]
                             ) -> np.ndarray:
        """Available shard chunks {id: (S, C)} -> logical payload
        (S, B·L) — the read path's decode_concat core."""
        msg, S, L = self._structured_message(chunks)
        data = msg.reshape(self.B, S, L).transpose(1, 0, 2)
        return np.ascontiguousarray(data.reshape(S, self.B * L))

    def decode_batch(self, chunks: Dict[int, np.ndarray],
                     want) -> Dict[int, np.ndarray]:
        """Reconstruct whole shard rows (the recovery shape).  With ≥d
        survivors this is the plain [[I],[Ψ]] matrix path on the device
        backend (two K1 launches on the card: the inverted-survivor
        solve, then the Ψ projection); below d the product-matrix
        structure recovers the message from any k on the host and
        re-projects."""
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise IOError(
                f"need at least k={self.k} chunks, have {len(avail)}")
        some = np.asarray(chunks[avail[0]])
        S, C = some.shape
        out: Dict[int, np.ndarray] = {
            i: np.asarray(chunks[i], dtype=np.uint8)
            for i in want if i in chunks}
        miss = [i for i in want if i not in chunks]
        if not miss:
            return out
        if len(avail) >= self.d:
            srcs = avail[:self.d]
            row_ids = tuple(self.rows + h for h in srcs)
            self._single_device()
            dev = self.device()
            survivors = np.stack(
                [np.asarray(chunks[i], dtype=np.uint8) for i in srcs],
                axis=1)
            m_rows = dev.decode_data(survivors, row_ids,
                                     tuple(range(self.rows)))
            allc = dev.encode(m_rows)
            for i in miss:
                out[i] = allc[:, i, :]
            return out
        # fewer than d survivors: structured decode, then re-project
        msg, S2, L = self._structured_message(chunks)
        m_rows = self._message_to_rows(msg, S2, L)
        rows = gf_matvec_bytes(self.psi[miss, :], m_rows)
        for idx, i in enumerate(miss):
            out[i] = rows[idx].reshape(S, C)
        return out

    def decode(self, want_to_read: Set[int],
               chunks: Dict[int, np.ndarray],
               chunk_size: int = 0) -> Dict[int, np.ndarray]:
        from .base import as_chunk
        arrs = {i: as_chunk(c) for i, c in chunks.items()}
        if want_to_read <= set(arrs):
            return {i: arrs[i] for i in want_to_read}
        got = self.decode_batch({i: a[None, :] for i, a in arrs.items()},
                                sorted(want_to_read))
        return {i: np.ascontiguousarray(b).reshape(-1)
                for i, b in got.items()}

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        got = self.decode(set(want_to_read), chunks)
        for i, buf in got.items():
            decoded[i][...] = buf

    def decode_concat(self, chunks: Dict[int, np.ndarray]) -> bytes:
        from .base import as_chunk
        arrs = {i: as_chunk(c)[None, :] for i, c in chunks.items()}
        return self.decode_payload_batch(arrs)[0].tobytes()

    # ---- repair (the point of the family) ---------------------------------
    def repair_mu(self, lost: int) -> np.ndarray:
        """The combination vector helpers project their stored row
        onto: Ψ_f for MBR (M is d×d), Φ_f for MSR (M is 2α×α)."""
        return self.psi[lost, :self.cols].copy()

    def repair_contribution(self, helper: int, lost: int,
                            body: np.ndarray) -> np.ndarray:
        """Helper-side repair math: stored chunk rows (S, C) -> the β·L
        bytes this shard contributes, (Ψ_h M)·μ_f per stripe."""
        S, C = body.shape
        L = self._sub_l(C)
        blocks = np.ascontiguousarray(
            np.asarray(body, dtype=np.uint8)
            .reshape(S, self.cols, L).transpose(1, 0, 2)
        ).reshape(self.cols, S * L)
        mu = self.repair_mu(lost)
        out = gf_matvec_bytes(mu[None, :], blocks)
        return np.ascontiguousarray(out.reshape(S, L))

    def repair_bytes_per_shard(self, chunk_size: int) -> int:
        """Helper bytes moved to repair one shard of *chunk_size*."""
        return self.d * self.beta * self._sub_l(chunk_size)

    def repair(self, lost: int, contributions: Dict[int, np.ndarray]
               ) -> np.ndarray:
        """Collector-side repair: d helper contributions {helper:
        (S, L)} -> the lost shard's chunk rows (S, C).  The d×d solve
        runs on the device backend (one K1 launch on the card).  A
        helper set of the wrong size raises ``IOError`` and a lost shard
        among the helpers ``ValueError``: the refusals the recovery
        scheduler answers with a full-stripe round."""
        helpers = sorted(contributions)
        if len(helpers) != self.d:
            raise IOError(
                f"repair needs exactly d={self.d} contributions, "
                f"have {len(helpers)}")
        if lost in contributions:
            raise ValueError("lost shard cannot help repair itself")
        some = np.asarray(contributions[helpers[0]])
        S, L = some.shape
        stacked = np.stack([
            np.asarray(contributions[h], dtype=np.uint8).reshape(-1)
            for h in helpers])                      # (d, S·L)
        row_ids = tuple(self.rows + h for h in helpers)
        self._single_device()
        u = self.device().decode_data(stacked[None], row_ids,
                                      tuple(range(self.rows)))[0]
        u = np.asarray(u, dtype=np.uint8).reshape(self.rows, S, L)
        if self.technique == "pm_msr":
            lam_f = int(self._lambda[lost])
            rep = u[:self.alpha] ^ MUL_TABLE[lam_f][u[self.alpha:]]
        else:
            # M symmetric: M·Ψ_f^T IS the lost row's sub-chunk vector
            rep = u
        chunk = np.ascontiguousarray(
            rep.transpose(1, 0, 2).reshape(S, self.cols * L))
        return chunk
