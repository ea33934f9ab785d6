"""Encrypted execution of compiled circuits, counterpart of
``dct_cryptonets_tpu.fhe.runtime``.

Ciphertext tensors are ``int64`` (B, n1, H, W, C) on the module's device.
Levelled integer convolutions split each ciphertext into 8 balanced byte
planes and run them as exact int8 products (im2col + ``torch._int_mm``),
recombined with shifts mod 2^64.  TLUs gather every site of a layer into
batched bootstraps (``fhe.pbs``) whose blind rotates run the hand-written
CMUX kernels on the GPU.  Client-side encrypt/decrypt stays in numpy
(``fhe.keys``, the port's copy of the JAX package's), so both packages
produce the same keys and ciphertexts from the same seeds.

Two drop policies: ``"none"`` runs every bootstrap with all key limbs
(bit-exact against the simulator while the noise stays below half an
accumulator LSB); ``"audit"`` runs each TLU layer at the throughput knobs
that the circuit noise audit (``fhe.noise_audit``) proves safe under the
per-PBS ``p_error`` (Concrete's semantics): main (drop_limbs, cross) per
layer, partial clearing ``keep_low`` per layer, and the extraction
lattice's knob and truncated keyswitches.

The module runs on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a GPU, :func:`default_device` raises.
"""
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.distributed import all_reduce, coll_device
from ..parallel.mesh import process_rank, replicate, shard_batch, shard_rows
from . import torus as T
from .circuit import (AddScaled, AddScaledPC, Circuit, Conv, Output, PoolSum,
                      QuantIn, Rescale, Tlu, Window, simulate)
from .intmm import conv_out_hw, im2col, int8_matmul
from .keys import (ClientKeys, Csprng, decrypt_lwe, encrypt_lwe, keygen,
                   make_aux_server_keys, make_server_keys)
from .noise_audit import AuditResult, audit_circuit
from .params import (ExactRoundingConfig, TFHEParams, default_exact_rounding,
                     params_for_precision)
from .pbs import (DeviceAuxKeys, DeviceServerKeys, bootstrap_chunked,
                  clear_low_bits_chunked, preprocess_aux_keys,
                  preprocess_server_keys, with_precomputed_strips)

U64 = np.uint64
I64 = torch.int64
DROP_POLICIES = ("none", "audit")


def default_device() -> torch.device:
    """The port's device: CUDA.  Raises when no GPU is usable; the CPU is
    used only when a caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on an NVIDIA GPU; "
                           "pass device='cpu' (--device cpu) to run its "
                           "plain versions on the CPU")
    return torch.device("cuda")


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _conv_limbs(ct: torch.Tensor, w: np.ndarray, stride: int,
                padding: int) -> torch.Tensor:
    """Integer conv of a ciphertext tensor by plaintext integer weights.

    ct: (B, n1, H, W, C) int64 (n1 = LWE size, treated as batch);
    w: (kh, kw, C, Cout) int32.  Each of the 8 balanced byte planes runs as
    one exact int8 x int8 -> int32 product (|w| <= 127, every QAT config);
    wider weights take an exact float64 product.
    """
    B, n1, H, W, C = ct.shape
    kh, kw, _, cout = w.shape
    oh, ow = conv_out_hw(H, W, kh, kw, stride, padding)
    bb = T.balanced_bytes(ct).reshape(8, B * n1, H, W, C)
    wide = w.size and int(np.abs(w).max()) > 127
    wm = torch.as_tensor(np.asarray(w).reshape(-1, cout),
                         dtype=torch.float64 if wide else torch.int8,
                         device=ct.device)
    acc = T.zeros((B * n1 * oh * ow, cout), ct.device)
    for u in range(8):
        cols = im2col(bb[u], kh, kw, stride, padding)
        if wide:
            y = torch.round(cols.to(torch.float64) @ wm).to(I64)
        else:
            y = int8_matmul(cols, wm).to(I64)
        acc += y << (8 * u)
    return acc.reshape(B, n1, oh, ow, cout)


def _pool_limbs(ct: torch.Tensor, k: int) -> torch.Tensor:
    """Window-sum pooling with wrapping int64 adds."""
    B, n1, H, W, C = ct.shape
    oh, ow = H // k, W // k
    x = ct[:, :, :oh * k, :ow * k].reshape(B, n1, oh, k, ow, k, C)
    return x.sum(dim=(3, 5))


def _set_body(flat: torch.Tensor, body: torch.Tensor) -> torch.Tensor:
    return torch.cat([flat[:, :-1], body], dim=1)


@dataclass
class CompiledModule:
    """Compiled circuit + keys: the ``q_module`` surface the reference
    drives (``forward(x, fhe="simulate" | "execute")``).  ``device``:
    default CUDA (:func:`default_device`); ``"cpu"`` only when asked."""
    circuit: Circuit
    params: TFHEParams
    client_keys: ClientKeys | None = None
    device_keys: DeviceServerKeys | None = None
    pbs_batch: int = 2048
    aux_batch: int = 4096
    stats: dict = field(default_factory=dict)
    rounding_method: str = "exact"
    exact_cfg: ExactRoundingConfig | None = None
    aux_keys: DeviceAuxKeys | None = None
    # extraction knobs: the aux blind rotate's limb drop (None: the audit's
    # under "audit", 0 under "none", set at keygen) and cross skip, and the
    # truncated-KSK limb drops of its two keyswitch hops
    aux_drop_limbs: int | None = None
    aux_cross: int = 0
    aux_fwd_ks_drop: int = 0
    aux_back_ks_drop: int = 0
    # "none": every limb of every key; "audit": the noise audit's knobs
    drop_policy: str = "none"
    p_error: float = 0.01
    device: torch.device | None = None
    audit: AuditResult | None = field(default=None, repr=False)
    # (mesh, parallel.Replicated of (device_keys, aux_keys)) after
    # shard_over
    replicas: tuple | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.drop_policy not in DROP_POLICIES:
            raise ValueError(f"unknown drop_policy {self.drop_policy!r}")
        if self.device is None:
            self.device = default_device()
        self.device = torch.device(self.device)

    # -- reference-compatible helpers ------------------------------------
    def maximum_integer_bit_width(self) -> int:
        return self.circuit.max_bit_width()

    def _needs_extraction(self) -> bool:
        return (self.rounding_method == "exact"
                and any(isinstance(op, Tlu) and op.spec.shift > 0
                        for op in self.circuit.ops))

    def run_audit(self) -> AuditResult:
        """The circuit noise audit of this module (computed once, then
        cached): per-TLU error probabilities and the knobs the "audit"
        policy runs."""
        if self.audit is None:
            if self.exact_cfg is None and self._needs_extraction():
                self.exact_cfg = default_exact_rounding(self.params)
            self.audit = audit_circuit(
                self.circuit, self.params, p_error=self.p_error,
                rounding_method=self.rounding_method,
                exact_cfg=self.exact_cfg)
        return self.audit

    def choose_aux_knobs(self):
        """Set the extraction knobs left at None: the audit's under
        "audit", no drops under "none".  :meth:`keygen` calls it; call it
        after taking keys made elsewhere."""
        if self.aux_drop_limbs is not None:
            return
        if self.drop_policy == "audit":
            a = self.run_audit()
            self.aux_drop_limbs, self.aux_cross = a.aux_drop_limbs, a.aux_cross
            self.aux_fwd_ks_drop = a.aux_fwd_ks_drop
            self.aux_back_ks_drop = a.aux_back_ks_drop
        else:
            self.aux_drop_limbs = 0

    def keygen(self, seed: int = 0):
        t = time.time()
        self.client_keys = keygen(self.params, seed)
        sk = make_server_keys(self.client_keys, seed + 1)
        self.device_keys = preprocess_server_keys(sk, self.device)
        if self._needs_extraction():
            if self.exact_cfg is None:
                self.exact_cfg = default_exact_rounding(self.params)
            ak = make_aux_server_keys(
                self.client_keys, self.exact_cfg.aux, seed=seed + 2,
                back_base_log=self.exact_cfg.back_base_log,
                back_levels=self.exact_cfg.back_levels)
            self.aux_keys = preprocess_aux_keys(ak, self.device)
            self.choose_aux_knobs()
            # the extraction lattice's strip table at the chosen drop, built
            # once (on the card, under the size gate): every blind rotate
            # of the run then streams it instead of building its strips
            self.aux_keys = with_precomputed_strips(
                self.aux_keys, self.exact_cfg.aux, self.aux_drop_limbs)
        _sync(self.device)
        self.stats["keygen_time"] = time.time() - t

    # -- client side ------------------------------------------------------
    def encrypt(self, x: np.ndarray, rng=None) -> torch.Tensor:
        """Quantize + encrypt a float input batch (B, H, W, C) ->
        (B, n1, H, W, C) int64 on the module's device.  ``rng``: a
        :class:`Csprng` (default: fresh OS entropy)."""
        return T.from_u64(self._encrypt_u64(x, rng), self.device)

    def _encrypt_u64(self, x: np.ndarray, rng=None) -> np.ndarray:
        """:meth:`encrypt`'s ciphertexts as uint64 (B, n1, H, W, C) on the
        host."""
        rng = rng or Csprng(None)
        qin = self.circuit.ops[0]
        assert isinstance(qin, QuantIn)
        qmax = 2 ** (qin.bits - 1) - 1
        qmin = -(2 ** (qin.bits - 1))
        x_int = np.clip(np.round(np.asarray(x) / qin.scale), qmin, qmax)
        with np.errstate(over="ignore"):
            mu = x_int.astype(np.int64).astype(U64) << U64(63 - qin.n)
        ct = encrypt_lwe(self.client_keys, mu, rng,
                         key=self.client_keys.big_lwe_key,
                         noise_log2=self.params.glwe_noise_log2)
        return np.moveaxis(ct, -1, 1)

    def _decode(self, ct: torch.Tensor, n: int) -> np.ndarray:
        """(B, n1, ...) ciphertexts -> signed ints at budget n, (B, ...)."""
        cts = np.moveaxis(T.to_u64(ct), 1, -1)
        phase = decrypt_lwe(self.client_keys, cts,
                            key=self.client_keys.big_lwe_key)
        shift = 63 - n
        with np.errstate(over="ignore"):
            v = (phase + (U64(1) << U64(shift - 1))) >> U64(shift)
        mod = 1 << (n + 1)
        v = (v & U64(mod - 1)).astype(np.int64)
        return np.where(v >= mod // 2, v - mod, v)

    def decrypt_feats(self, ct: torch.Tensor) -> np.ndarray:
        """Decrypt output ciphertexts -> float features (B, F)."""
        out_op = self.circuit.ops[-1]
        assert isinstance(out_op, Output)
        v = self._decode(ct, self.circuit.n_budget[out_op.x])
        return v.reshape(v.shape[0], -1).astype(np.float32) * out_op.scale

    # -- server side -------------------------------------------------------
    def run_encrypted(self, ct_in: torch.Tensor,
                      drop_limbs: int | None = None,
                      check_ref: dict | None = None) -> torch.Tensor:
        """Server-side evaluation with per-stage wall-clock accounting
        (``stats``: execute_time, levelled_time, pbs_time, pbs_per_sec, ...).

        ``drop_limbs``: one main limb drop for every TLU; None follows the
        policy (0 under "none", the audit's per-layer knobs under "audit").

        ``check_ref``: optional clear wire environment from
        ``simulate(..., return_env=True)``: every TLU output is decrypted
        and compared with its clear value (the realized-slip audit);
        mismatches are re-aligned on the body so each TLU measures its own
        slips."""
        if drop_limbs is None and self.drop_policy == "audit":
            self.run_audit()
        env = {}
        # free each ciphertext wire after its last consumer
        last_use: dict = {}
        for i, op in enumerate(self.circuit.ops):
            for attr in ("x", "a", "b"):
                w = getattr(op, attr, None)
                if w is not None:
                    last_use[w] = i
        dev = self.device
        pbs_count = slips = sites = 0
        slip_detail = []
        _sync(dev)
        t0 = time.time()
        t_lvl = t_pbs = t_audit = 0.0
        self._t_extract = 0.0
        result = None
        for i, op in enumerate(self.circuit.ops):
            t_op = time.time()
            if isinstance(op, QuantIn):
                env[op.out] = ct_in
            elif isinstance(op, Conv):
                env[op.out] = _conv_limbs(env[op.x], op.w, op.stride,
                                          op.padding)
            elif isinstance(op, PoolSum):
                env[op.out] = _pool_limbs(env[op.x], op.k)
            elif isinstance(op, Window):
                # zero padding = trivial all-zero ciphertexts
                p, s = op.pad, op.stride
                x = F.pad(env[op.x], (0, 0, p, p, p, p)) if p else env[op.x]
                env[op.out] = x[:, :, op.dy:op.dy + op.out_h * s:s,
                                op.dx:op.dx + op.out_w * s:s, :]
            elif isinstance(op, AddScaled):
                env[op.out] = (T.scalar_mul(env[op.a], op.ca * (1 << op.ja))
                               + T.scalar_mul(env[op.b],
                                              op.cb * (1 << op.jb)))
            elif isinstance(op, AddScaledPC):
                ma = torch.as_tensor(np.asarray(op.ca, np.int64)
                                     * (1 << op.ja), device=dev)
                mb = torch.as_tensor(np.asarray(op.cb, np.int64)
                                     * (1 << op.jb), device=dev)
                env[op.out] = (T.scalar_mul(env[op.a], ma)
                               + T.scalar_mul(env[op.b], mb))
            elif isinstance(op, Rescale):
                env[op.out] = T.shift_left(env[op.x], op.j)
            elif isinstance(op, Tlu):
                env[op.out] = self._run_tlu(env[op.x], op, drop_limbs)
                _sync(dev)
                shp = env[op.x].shape
                pbs_count += int(np.prod((shp[0],) + tuple(shp[2:])))
                t_pbs += time.time() - t_op
                if check_ref is not None:
                    t_ck = time.time()
                    got = self._decode(env[op.out],
                                       self.circuit.n_budget[op.out])
                    ref = np.asarray(check_ref[op.out], np.int64)
                    diff = ref - got
                    n_bad = int(np.count_nonzero(diff))
                    slips += n_bad
                    sites += got.size
                    n_gross = int(np.count_nonzero(np.abs(diff) > 1))
                    max_abs = int(np.abs(diff).max()) if n_bad else 0
                    slip_detail.append((op.out, n_bad, got.size, n_gross,
                                        max_abs))
                    if n_bad:
                        shift = 63 - self.circuit.n_budget[op.out]
                        cts = T.to_u64(env[op.out])
                        with np.errstate(over="ignore"):
                            cts[:, -1] += diff.astype(U64) << U64(shift)
                        env[op.out] = T.from_u64(cts, dev)
                    t_audit += time.time() - t_ck
            elif isinstance(op, Output):
                result = env[op.x]
            else:
                raise TypeError(op)
            if not isinstance(op, (QuantIn, Tlu, Output)):
                _sync(dev)
                t_lvl += time.time() - t_op
            for attr in ("x", "a", "b"):
                w = getattr(op, attr, None)
                if w is not None and last_use.get(w) == i:
                    env.pop(w, None)
        dt = time.time() - t0
        self.stats.update({
            "pbs_per_sample": self.circuit.num_pbs,
            "pbs_executed": pbs_count,
            "execute_time": dt - t_audit,
            "levelled_time": t_lvl,
            "pbs_time": t_pbs,
            "extract_time": self._t_extract,
            "pbs_per_sec": pbs_count / t_pbs if t_pbs > 0 else None,
        })
        if check_ref is not None:
            self.stats.update({"tlu_slips": slips, "tlu_sites": sites,
                               "tlu_slip_detail": slip_detail,
                               "audit_time": t_audit})
        return result

    def _run_tlu(self, ct: torch.Tensor, op: Tlu,
                 drop_limbs: int | None) -> torch.Tensor:
        cross = 0
        audited = self.drop_policy == "audit" and self.audit is not None
        if drop_limbs is None:
            drop_limbs = 0
            if audited:
                drop_limbs = self.audit.drop_for(op.x)
                cross = self.audit.cross_for(op.x)
        spec = op.spec
        B, n1, H, W, C = ct.shape
        M = B * H * W * C
        flat = ct.permute(0, 2, 3, 4, 1).reshape(M, n1)   # sites first
        n_in = spec.in_bits + spec.shift
        exact = self.rounding_method == "exact" and spec.shift > 0
        # body constant: recenter (+2^62) plus the rounding offset (the
        # full round-half-up constant before exact clearing, a half-LSB
        # dither in approximate mode; none when no bits are dropped)
        const = T.from_i32_shifted(1, 62, ct.device)
        if spec.shift > 0:
            off_log2 = (62 - spec.in_bits) if exact else (62 - n_in)
            const = const + T.from_i32_shifted(1, off_log2, ct.device)
        flat = _set_body(flat, flat[:, -1:] + const)
        # partial clearing (the audit's keep_low): the low `keep` dropped
        # bits stay uncleared and ride as a bounded offset
        keep = min(self.audit.keep_for(op.x), spec.shift) \
            if exact and audited else 0

        tables = torch.as_tensor(np.asarray(op.table, np.int32),
                                 device=ct.device)           # (C, 2^r)
        site_tables = tables.expand(B * H * W, C, -1).reshape(M, -1)
        out_delta = 63 - spec.out_n
        if exact and spec.shift > keep:
            assert self.aux_keys is not None, "keygen() first"
            cfg = self.exact_cfg
            t_ext = time.time()
            flat = clear_low_bits_chunked(
                flat, self.aux_keys, cfg.aux, n_in, spec.shift,
                cfg.back_base_log, cfg.back_levels, self.aux_batch,
                self.aux_drop_limbs, self.aux_cross, self.aux_fwd_ks_drop,
                self.aux_back_ks_drop, keep)
            _sync(self.device)
            self._t_extract += time.time() - t_ext
            self.stats["aux_pbs_executed"] = (
                self.stats.get("aux_pbs_executed", 0)
                + (spec.shift - keep) * M)
        if keep > 0:
            # center the uncleared junk on the window center: after the
            # clearing, so the subtraction cannot borrow into the cleared
            # bit field (before it, the main PBS would read one window low
            # for a 2^(keep-1)/2^shift fraction of accumulator values)
            cc = T.from_i32_shifted(1, 62 - n_in + keep, ct.device)
            flat = _set_body(flat, flat[:, -1:] - cc)
        out = bootstrap_chunked(flat, site_tables, self.device_keys,
                                self.params, out_delta, self.pbs_batch,
                                drop_limbs, cross)
        n_big = self.params.big_lwe_dim + 1
        return out.reshape(B, H, W, C, n_big).permute(0, 4, 1, 2, 3)

    # -- multi-device -----------------------------------------------------
    def shard_over(self, mesh):
        """Place the module's server key material on a device mesh.

        Server-side parallelism is ciphertext-batch data parallelism:
        ``device_keys`` and ``aux_keys`` replicate onto every device of
        the mesh (``parallel.replicate``: one copy per device; an entry on
        the module's own device shares its keys, so a one-entry mesh there
        copies nothing), and :meth:`forward` with ``mesh=mesh`` shards the
        ciphertext batch.  When the mesh spans processes, every rank calls
        this together and rank 0's keys are broadcast (the one-time key
        broadcast); the other ranks may hold none.  The unsharded path
        (``mesh=None``) keeps using ``device_keys`` as before."""
        if process_rank() == 0:
            assert self.device_keys is not None, "call keygen() first"
        keys = replicate(mesh, (self.device_keys, self.aux_keys))
        self.replicas = (mesh, keys)
        return self

    def _on_entry(self, mesh, i):
        """This module on mesh entry i: its device and its key copies,
        stats of its own."""
        dk, ak = self.replicas[1][i]
        return replace(self, device=mesh.devices[i], device_keys=dk,
                       aux_keys=ak, stats={}, replicas=None)

    def _run_sharded(self, ct: np.ndarray, drop_limbs, mesh,
                     env_ref) -> torch.Tensor:
        """run_encrypted on each of this process's shards of the uint64
        ciphertext batch ``ct``, on the shard's device with its keys; the
        outputs gathered (across processes too) and the stats merged (see
        :meth:`forward`)."""
        if self.replicas is None or self.replicas[0] != mesh:
            raise ValueError("call shard_over(mesh) before forward(mesh=)")
        if drop_limbs is None and self.drop_policy == "audit":
            self.run_audit()
        shards = shard_batch(mesh, np.ascontiguousarray(ct).view(np.int64))
        stats = []
        for i, part in shards.local():
            sub = self._on_entry(mesh, i)
            ref = None if env_ref is None else {
                k: v[shard_rows(len(ct), mesh, i)] for k, v in env_ref.items()}
            shards.shards[i] = sub.run_encrypted(part, drop_limbs,
                                                 check_ref=ref)
            stats.append(sub.stats)
        self._merge_stats(stats, mesh)
        return shards.gather()

    _SUMMED = ("pbs_executed", "aux_pbs_executed", "tlu_slips", "tlu_sites")
    _TIMERS = ("execute_time", "levelled_time", "pbs_time", "extract_time",
               "audit_time")

    def _merge_stats(self, stats: list, mesh):
        """The shards' stats as one batch's: counts and slips summed over
        the shards (all-reduced across processes), per-TLU slip detail
        summed per TLU (its largest slip the maximum); timers summed over
        this process's shards (they run one after another) and then the
        maximum across processes (the slowest bounds the batch)."""
        first = stats[0]
        counts = [sum(st.get(k, 0) for st in stats) for k in self._SUMMED]
        timers = [sum(st.get(k, 0.0) for st in stats) for k in self._TIMERS]
        detail = None
        if "tlu_slip_detail" in first:
            rows = zip(*(st["tlu_slip_detail"] for st in stats))
            detail = [(r[0][0], *(sum(x[j] for x in r) for j in (1, 2, 3)),
                       max(x[4] for x in r)) for r in rows]
        if mesh.spans_processes:
            dev = coll_device()
            c = torch.tensor(counts + [v for d in detail or ()
                                       for v in d[1:4]],
                             dtype=torch.int64, device=dev)
            t = torch.tensor(timers + [d[4] for d in detail or ()],
                             dtype=torch.float64, device=dev)
            all_reduce(c)
            all_reduce(t, dist.ReduceOp.MAX)
            c, t = c.tolist(), t.tolist()
            counts, timers = c[:len(counts)], t[:len(timers)]
            if detail is not None:
                detail = [(d[0], *c[len(counts) + 3 * j:len(counts) + 3 * j
                                    + 3], int(t[len(timers) + j]))
                          for j, d in enumerate(detail)]
        merged = dict(zip(self._SUMMED, counts))
        merged.update(zip(self._TIMERS, timers))
        merged["aux_pbs_executed"] += self.stats.get("aux_pbs_executed", 0)
        merged["pbs_per_sample"] = first["pbs_per_sample"]
        merged["pbs_per_sec"] = (merged["pbs_executed"] / merged["pbs_time"]
                                 if merged["pbs_time"] > 0 else None)
        if detail is None:
            for k in ("tlu_slips", "tlu_sites", "audit_time"):
                merged.pop(k)
        else:
            merged["tlu_slip_detail"] = detail
        self.stats.update(merged)

    # -- the reference-style entry point ----------------------------------
    def forward(self, x: np.ndarray, fhe: str = "simulate",
                drop_limbs: int | None = None, mesh=None,
                enc_rng=None, check_ref: bool = False) -> np.ndarray:
        """x: float input batch (B, H, W, C) -> float features (B, F).

        fhe='simulate': bit-exact integer simulation (clear);
        fhe='execute': encrypt -> encrypted eval -> decrypt.

        ``mesh`` (execute; after :meth:`shard_over`): a remainder batch is
        padded to a multiple of the mesh size by repeating its last
        sample, the whole padded batch is encrypted (so ``enc_rng`` draws
        what the unsharded run of it draws), each shard runs on its
        entry's device, and the outputs are gathered, decrypted and cut
        back to the batch.  With ``check_ref`` the padded batch is
        simulated and each shard checked against its rows; the slip
        counts in ``stats`` are then the whole batch's, and the timers
        are summed over this process's shards and the largest across
        processes.  Across processes every rank calls this with the same
        batch and an ``enc_rng`` of the same seed."""
        n = len(x)
        if mesh is not None and fhe == "execute" and n % mesh.size:
            x = np.concatenate([x, np.repeat(x[-1:], mesh.size - n % mesh.size,
                                             axis=0)], axis=0)
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        if fhe == "simulate":
            return simulate(self.circuit, xt).cpu().numpy()
        if fhe == "execute":
            assert self.client_keys is not None, "call keygen() first"
            env_ref = None
            if check_ref:
                _, env = simulate(self.circuit, xt, return_env=True)
                env_ref = {k: v.cpu().numpy() for k, v in env.items()}
            if mesh is not None:
                ct = self._encrypt_u64(x, rng=enc_rng)
                out = self._run_sharded(ct, drop_limbs, mesh, env_ref)
                return self.decrypt_feats(out)[:n]
            ct = self.encrypt(x, rng=enc_rng)
            out = self.run_encrypted(ct, drop_limbs, check_ref=env_ref)
            return self.decrypt_feats(out)
        raise ValueError(f"unknown fhe mode {fhe!r}")


def compile_qat_model(params, state, spec, *, n_bits: int = 5,
                      rounding_threshold_bits=6,
                      calib_absmax: float | None = None,
                      calib_data=None,
                      tfhe_params: TFHEParams | None = None,
                      pbs_batch: int = 2048,
                      drop_policy: str = "none",
                      p_error: float = 0.01,
                      range_margin: float = 1.0,
                      residual_mode: str = "fused",
                      device=None) -> CompiledModule:
    """QAT model (numpy params/state pytree) -> circuit -> executable
    module on ``device`` (default CUDA; ``"cpu"`` only when asked).
    ``rounding_threshold_bits``: an int (method "exact") or
    ``{"n_bits": r, "method": "exact" | "approximate"}``."""
    from .compiler import lower
    method = "exact"
    if isinstance(rounding_threshold_bits, dict):
        method = rounding_threshold_bits.get("method", "exact")
        rounding_threshold_bits = rounding_threshold_bits["n_bits"]
    if method not in ("exact", "approximate"):
        raise ValueError(f"unknown rounding method {method!r}")
    if drop_policy not in DROP_POLICIES:
        raise ValueError(f"unknown drop_policy {drop_policy!r}")
    circ = lower(params, state, spec, n_bits=n_bits,
                 rounding_threshold_bits=rounding_threshold_bits,
                 calib_absmax=calib_absmax, calib_data=calib_data,
                 range_margin=range_margin, residual_mode=residual_mode)
    max_r = max(op.spec.in_bits for op in circ.ops if isinstance(op, Tlu))
    p = tfhe_params or params_for_precision(max_r)
    return CompiledModule(circ, p, pbs_batch=pbs_batch,
                          rounding_method=method, drop_policy=drop_policy,
                          p_error=p_error, device=device)


def compile_ptq_model(params, state, spec, calib_data, *, n_bits: int = 5,
                      rounding_threshold_bits=6,
                      tfhe_params: TFHEParams | None = None,
                      pbs_batch: int = 2048, device=None) -> CompiledModule:
    """Post-training quantization compile of a trained float model (the
    reference's path for checkpoints without 'qat' in the model name):
    weights per-tensor quantized to ``n_bits``, activation scales
    calibrated on ``calib_data`` with running-stats BatchNorm
    (``models.resnet.quantize_float_model``), then the QAT compile."""
    from ..models.resnet import quantize_float_model
    x = calib_data if isinstance(calib_data, torch.Tensor) else \
        torch.as_tensor(np.asarray(calib_data, np.float32))
    params_q, spec_q = quantize_float_model(params, state, x, spec,
                                            n_bits=n_bits)
    return compile_qat_model(params_q, state, spec_q, n_bits=n_bits,
                             rounding_threshold_bits=rounding_threshold_bits,
                             calib_data=calib_data, tfhe_params=tfhe_params,
                             pbs_batch=pbs_batch, device=device)
