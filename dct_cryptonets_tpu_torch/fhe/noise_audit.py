"""Circuit-level noise audit, counterpart of
``dct_cryptonets_tpu.fhe.noise_audit`` (pure numpy, the same numbers and
the same greedy steps, so both packages pick the same knobs for the same
circuit).

Per-TLU error probabilities and safe throughput knobs, derived from the
actual integer weights: the audit propagates ciphertext noise *variance*
through the levelled graph using the real conv kernels and add
multipliers, then checks every decision the encrypted runtime makes:

* the **main PBS window decision** of each TLU — margin ``2^(62 - in_bits)``
  against input noise + keyswitch + mod-switch (+ exact-rounding extraction
  injections);
* the **top extraction-bit guard** of exact rounding — the bit lo =
  shift-1 sign decision sees the accumulator noise amplified by
  ``2^(n_in - lo)`` against a quarter-torus margin.  Lower-bit misreads
  self-cancel (the bit subtracted is the bit read); the top bit is the
  binding one because its misread moves the phase by a full window.

It also chooses, per TLU layer, the main blind rotate's (drop_limbs,
cross) knob and the partial-clearing depth ``keep_low`` (the low dropped
accumulator bits left uncleared, riding as a centered bounded offset),
and, for the extraction lattice, one (drop_limbs, cross) knob and the two
truncated-keyswitch drops: the largest savings that keep every decision
within the target ``p_error`` (Concrete's optimizer role).
"""
import math
from dataclasses import dataclass, field

import numpy as np

from .circuit import (AddScaled, AddScaledPC, Circuit, Conv, Output,
                      PoolSum, QuantIn, Rescale, Tlu, Window)
from .params import (ExactRoundingConfig, NoiseModel, TFHEParams,
                     default_exact_rounding)

MAX_DROP = 4   # limb drops >= 5 are catastrophic for every preset

# Throughput knob ladder for one blind rotate, MOST AGGRESSIVE (fewest int8
# matmuls) first: (drop_limbs, cross).  ``cross=1`` additionally skips the
# (low digit byte x lowest kept key limb) products (pbs.py blind_rotate
# ``cross``).  Both the added variance and the matmul count are monotone
# along the ladder: var(d,1) ~ 4x the marginal variance of limb d-1, so
# (d,1) sits strictly between (d,0) and (d+1,0).
KNOB_LADDER = [(d, c) for d in range(MAX_DROP, -1, -1) for c in (1, 0)]


def _knob_var(nm: NoiseModel, knob: tuple) -> float:
    d, c = knob
    return nm.var_drop_limbs(d) + (nm.var_drop_cross(d) if c else 0.0)


def _conv_amp2(w: np.ndarray) -> float:
    """Worst per-output-channel squared-L2 weight sum (variance gain)."""
    w = np.asarray(w, np.float64)
    return float((w * w).sum(axis=(0, 1, 2)).max())


@dataclass
class TluReport:
    acc: str                  # accumulator tensor (decision site)
    sites: int                # PBS sites per sample
    in_bits: int
    shift: int
    drop_limbs: int           # chosen main blind-rotate limb drop
    p_window: float           # main window-decision error probability
    p_extract: float          # extraction-guard error (exact mode)
    cross: int = 0            # chosen main cross skip (pbs.py ``cross``)
    keep_low: int = 0         # low accumulator bits left uncleared

    @property
    def cleared(self) -> int:
        """Aux bootstraps actually paid per site."""
        return max(self.shift - self.keep_low, 0)

    @property
    def p_total(self) -> float:
        return min(1.0, self.p_window + self.p_extract)


@dataclass
class AuditResult:
    params: TFHEParams
    p_error: float
    rounding_method: str
    aux_drop_limbs: int
    aux_cross: int = 0
    # truncated-KSK limb drops for the extraction pipeline's two keyswitch
    # hops (pbs.lwe_key_switch ``ks_drop``; NoiseModel.var_ks_drop)
    aux_fwd_ks_drop: int = 0
    aux_back_ks_drop: int = 0
    reports: list = field(default_factory=list)
    by_acc: dict = field(default_factory=dict)

    @property
    def max_p_error(self) -> float:
        return max((r.p_total for r in self.reports), default=0.0)

    def drop_for(self, acc_name: str) -> int:
        return self.by_acc[acc_name].drop_limbs

    def cross_for(self, acc_name: str) -> int:
        return self.by_acc[acc_name].cross

    def keep_for(self, acc_name: str) -> int:
        return self.by_acc[acc_name].keep_low

    def summary(self) -> str:
        lines = [f"noise audit: {len(self.reports)} TLU layers, "
                 f"method={self.rounding_method}, target p_error "
                 f"{self.p_error}, aux_drop={self.aux_drop_limbs}"
                 f"+x{self.aux_cross}"]
        for r in self.reports:
            lines.append(
                f"  {r.acc:<10} sites={r.sites:<6} r={r.in_bits} "
                f"shift={r.shift} keep={r.keep_low} "
                f"drop={r.drop_limbs}+x{r.cross} "
                f"p_window={r.p_window:.2e} p_extract={r.p_extract:.2e}")
        lines.append(f"  max per-PBS p_error: {self.max_p_error:.2e}")
        return "\n".join(lines)


def _erfc_z(margin: float, var: float) -> float:
    if var <= 0:
        return 0.0
    return math.erfc(margin / math.sqrt(var) / math.sqrt(2.0))


def audit_circuit(circ: Circuit, params: TFHEParams, *,
                  p_error: float = 0.01,
                  rounding_method: str = "exact",
                  exact_cfg: ExactRoundingConfig | None = None,
                  enc_noise_log2: float | None = None,
                  sigma_margin: float = 1.0) -> AuditResult:
    """Audit every TLU decision and choose safe per-layer limb drops.

    Returns an :class:`AuditResult`; ``result.max_p_error`` > ``p_error``
    means the circuit violates the contract even with no dropped limbs
    (e.g. a conv with an extreme weight norm) — the caller should raise or
    re-lower with wider parameters, mirroring Concrete's infeasibility
    errors.

    ``sigma_margin``: optional extra factor on every modeled decision
    sigma (variance x ``sigma_margin**2``) for sensitivity experiments.
    NOTE a global margin cannot be used as a calibration lever here: the
    r=6 flagship sits at the modeled KS+MS noise floor, so even 1.05
    makes every layer infeasible.  The measured round-5 model-vs-realized
    gap is instead fixed structurally — correlated extraction-injection
    pricing in ``decision_p`` (see the comment there).
    """
    nm = NoiseModel(params)
    sm2 = float(sigma_margin) ** 2
    var_fixed = nm.var_keyswitch() + nm.var_mod_switch()
    var_enc = 2.0 ** (2 * (enc_noise_log2 if enc_noise_log2 is not None
                           else params.glwe_noise_log2))

    aux_fwd_ks_drop = aux_back_ks_drop = 0
    if rounding_method == "exact":
        if exact_cfg is None:
            exact_cfg = default_exact_rounding(params)
        aux = exact_cfg.aux
        aux_nm = NoiseModel(aux)
        # noise injected into the accumulator per extracted bit: the aux
        # blind-rotate output (+ dropped aux limbs/cross) + the back
        # keyswitch (+ its truncated-KSK limbs)
        big_n = aux.glwe_dim * aux.poly_size
        main_big_n = params.glwe_dim * params.poly_size
        B = 2.0 ** exact_cfg.back_base_log
        l = exact_cfg.back_levels
        q = 2.0 ** 64
        var_ks_back = (big_n * l * var_enc * (B * B + 2.0) / 12.0
                       + big_n * (q / B ** l) ** 2 / 24.0)

        def pick_ks_drop(rows, n_dst, base, cap_var):
            d = 0
            for t in range(1, 7):
                if NoiseModel.var_ks_drop(rows, n_dst, base, t) <= cap_var:
                    d = t
            return d

        # fwd hop noise sits on the extraction SIGN decision whose margin
        # is a quarter torus (2^62): capping the added variance at 2^112
        # keeps its z-contribution >= 32 sigma — negligible next to the
        # shifted accumulator noise p_extract already accounts
        aux_fwd_ks_drop = pick_ks_drop(main_big_n * aux.ks_levels,
                                       aux.lwe_dim, aux.ks_base_log,
                                       2.0 ** 112)
        # back hop noise joins bit_var below; cap at ~4x the aux
        # blind-rotate variance so it never dominates the injection term
        aux_back_ks_drop = pick_ks_drop(big_n * l, main_big_n,
                                        exact_cfg.back_base_log,
                                        aux_nm.var_blind_rotate() * 4.0)
        var_ks_back += NoiseModel.var_ks_drop(big_n * l, main_big_n,
                                              exact_cfg.back_base_log,
                                              aux_back_ks_drop)

        def bit_var(knob):
            return (aux_nm.var_blind_rotate() + _knob_var(aux_nm, knob)
                    + var_ks_back)

        Bf = 2.0 ** aux.ks_base_log
        lf = aux.ks_levels
        var_ks_fwd = (main_big_n * lf * aux_nm.var_fresh_lwe()
                      * (Bf * Bf + 2.0) / 12.0
                      + main_big_n * (q / Bf ** lf) ** 2 / 24.0
                      + NoiseModel.var_ks_drop(main_big_n * lf, aux.lwe_dim,
                                               aux.ks_base_log,
                                               aux_fwd_ks_drop))
        var_aux_sign = aux_nm.var_mod_switch() + var_ks_fwd
    else:
        var_aux_sign = 0.0

        def bit_var(knob):
            return 0.0

    # ---- forward sensitivity pass: tensor -> {source: amp2}
    # sources are 'enc' or TLU accumulator names (their PBS outputs)
    senses: dict[str, dict[str, float]] = {}
    tlus: list[Tlu] = []
    shapes = circ.meta["shapes"]
    decision_sources: dict[str, dict[str, float]] = {}

    def scaled(m: dict, f: float) -> dict:
        return {k: v * f for k, v in m.items()}

    for op in circ.ops:
        if isinstance(op, QuantIn):
            senses[op.out] = {"enc": 1.0}
        elif isinstance(op, Conv):
            senses[op.out] = scaled(senses[op.x], _conv_amp2(op.w))
        elif isinstance(op, PoolSum):
            senses[op.out] = scaled(senses[op.x], float(op.k * op.k))
        elif isinstance(op, Window):
            senses[op.out] = dict(senses[op.x])
        elif isinstance(op, Rescale):
            senses[op.out] = scaled(senses[op.x], 4.0 ** op.j)
        elif isinstance(op, (AddScaled, AddScaledPC)):
            if isinstance(op, AddScaledPC):
                fa = float(np.abs(op.ca).max() * (1 << op.ja)) ** 2
                fb = float(np.abs(op.cb).max() * (1 << op.jb)) ** 2
            else:
                fa = float(op.ca * (1 << op.ja)) ** 2
                fb = float(op.cb * (1 << op.jb)) ** 2
            m = scaled(senses[op.a], fa)
            for k, v in scaled(senses[op.b], fb).items():
                m[k] = m.get(k, 0.0) + v
            senses[op.out] = m
        elif isinstance(op, Tlu):
            decision_sources[op.x] = dict(senses[op.x])
            tlus.append(op)
            senses[op.out] = {op.x: 1.0}
        elif isinstance(op, Output):
            pass

    # ---- choose knobs + partial-clearing depth JOINTLY, cost-aware.
    #
    # The old two-phase scheme (maximize limb drops until the worst
    # decision sits at p_error, THEN try keep_low with the leftover slack)
    # systematically starved keep_low: the last drop rung saves ~10% of a
    # main PBS while one keep_low step saves a whole extraction bootstrap
    # per site (~1.4 main-dot units) — the budget was spent on the cheaper
    # lever.  Instead, start from the SAFEST configuration and greedily
    # take the single move (drop one ladder rung somewhere, deepen one
    # keep_low, lower the aux knob) with the best cost saving that keeps
    # every decision within p_error — the same role Concrete's optimizer
    # plays when it picks per-op parameters under a global p_error.
    LAST = len(KNOB_LADDER) - 1
    ki: dict[str, int] = {t.x: 0 for t in tlus}     # index into KNOB_LADDER
    ku: dict[str, int] = {t.x: 0 for t in tlus}     # keep_low per TLU

    def src_var(name: str) -> float:
        if name == "enc":
            return var_enc
        return nm.var_blind_rotate() + _knob_var(nm, KNOB_LADDER[ki[name]])

    def decision_p(t: Tlu) -> tuple[float, float]:
        u = ku[t.x]
        shift = t.spec.shift
        n_in = t.spec.in_bits + shift
        cleared = max(shift - u, 0)
        var_in = sum(a2 * src_var(s)
                     for s, a2 in decision_sources[t.x].items())
        # Per-bit extraction injections are priced as FULLY CORRELATED
        # ((sum sigma)^2 = cleared^2 * var, the Cauchy-Schwarz upper
        # bound), not independent (cleared * var).  Calibrated against the
        # TPU package's round-5 full-image slip audit (ROUND5.md): realized
        # per-TLU slip rates scaled with shift exactly as the correlated
        # law predicts (shift 5 -> 1.0x modeled, 6 -> 1.8x, 7 -> 2.6x,
        # 9 -> 2.9x under the old independent law; the correlated law fits
        # all four within measurement noise) — the per-bit injected
        # errors share the same aux BSK dropped-limb pattern and back-KSK
        # decomposition remainders, so they do not average independently.
        var_in += (cleared ** 2) * bit_var(KNOB_LADDER[aux_ki])
        margin_w = 2.0 ** (62 - t.spec.in_bits)
        # partial clearing: the uncleared low u bits ride as a centered
        # BOUNDED offset, |junk| <= 2^(u-1)*Delta after the runtime's
        # centering constant.  A bounded deterministic offset is priced by
        # SHRINKING the decision margin by its worst case — strictly sound
        # for any junk distribution and far tighter than folding a
        # uniform's variance into the Gaussian tail (which overstates the
        # slip probability grossly as u approaches shift and kept the
        # audit from choosing deep keep_low).
        junk_bound = 2.0 ** (62 - n_in + u) if u > 0 else 0.0
        p_w = _erfc_z(margin_w - junk_bound, (var_in + var_fixed) * sm2)
        if margin_w <= junk_bound:
            p_w = 1.0
        p_x = 0.0
        if rounding_method == "exact" and cleared > 0:
            # top extraction bit (lo = shift-1): guard margin is the
            # quarter torus minus the uncleared-junk span, de-amplified by
            # the shift-up factor 2^(n_in - lo).  At u=0 this reduces to
            # the classic margin_w/2 vs unamplified accumulator noise.
            # Lower-bit misreads self-cancel (see module docstring); the
            # top bit is binding because its misread moves a full window.
            m_top = ((2.0 ** 62 - (2.0 ** u - 1.0) * 2.0 ** (63 - shift))
                     / 2.0 ** (n_in - shift + 1))
            p_x = _erfc_z(m_top, var_in * sm2)
            # aux-side (fwd-KS + mod-switch) sign slips: margin shrinks to
            # 2^(62-u) at the lowest extracted bit — negligible at u=0,
            # the binding constraint on large u
            for lo in range(u, shift):
                m_aux = 2.0 ** 62 - (2.0 ** u - 1.0) * 2.0 ** (62 - lo)
                p_x += _erfc_z(m_aux, var_aux_sign * sm2)
        return p_w, p_x

    # start SAFEST: no drops anywhere, full clearing, safest aux knob
    for t in tlus:
        ki[t.x] = LAST
    aux_ki = LAST
    KEEP_MAX = 6      # beyond this the per-bit aux sign margin 2^(62-u)
    #                   approaches the aux KS+MS noise floor

    stuck: set[str] = set()   # TLUs infeasible even with everything safest
    for t in tlus:
        p_w, p_x = decision_p(t)
        if p_w + p_x > p_error:
            # cannot be met by any knob (floor = var_fixed + baseline
            # noise) — park it; the caller sees it via max_p_error
            stuck.add(t.x)

    # -- cost model (units: one main external-product byte-pair matmul)
    def _pair_count(nbytes: int, drop: int, cross: int) -> int:
        n = 0
        for u in range(nbytes):
            for vi in range(8 - drop):
                if u + vi + drop >= 8 or u + vi < cross:
                    continue
                n += 1
        return n

    dby_main = max(1, (params.pbs_base_log + 7) // 8)
    # one extraction bit costs ~0.143 of a (2,x1) 10-dot main PBS: the JAX
    # package's cost model from its TPU rates (PERFORMANCE.md), kept as it
    # is so that both packages pick the same knobs
    _AUX_REF_COST = 0.143 * _pair_count(dby_main, 2, 1)
    if rounding_method == "exact":
        dby_aux = max(1, (exact_cfg.aux.pbs_base_log + 7) // 8)

    def bit_cost(aux_knob) -> float:
        if rounding_method != "exact":
            return 0.0
        return (_AUX_REF_COST * _pair_count(dby_aux, *aux_knob)
                / _pair_count(dby_aux, 3, 1))

    sites_of = {t.x: float(np.prod(shapes[t.x])) for t in tlus}

    def total_cost() -> float:
        bc = bit_cost(KNOB_LADDER[aux_ki])
        c = 0.0
        for t in tlus:
            c += sites_of[t.x] * (
                _pair_count(dby_main, *KNOB_LADDER[ki[t.x]])
                + max(t.spec.shift - ku[t.x], 0) * bc)
        return c

    # consumers[name] = TLUs whose window decision sees name's PBS noise
    consumers: dict[str, list] = {t.x: [] for t in tlus}
    for t in tlus:
        for s in decision_sources[t.x]:
            if s in consumers:
                consumers[s].append(t)

    def moved_ok(affected) -> bool:
        for t in affected:
            if t.x in stuck:
                continue
            p_w, p_x = decision_p(t)
            if p_w + p_x > p_error:
                return False
        return True

    # -- greedy descent: take the feasible single move with the largest
    # cost saving until none remains
    for _ in range(len(tlus) * (LAST + KEEP_MAX + 1) + LAST + 4):
        base = total_cost()
        best = None                       # (saving, kind, name)
        for t in tlus:
            name = t.x
            if name in stuck:
                # infeasible even at the safest config: hold it there (the
                # report surfaces the violation); moved_ok ignores stuck
                # decisions, so moves here would otherwise run unchecked
                continue
            if ki[name] > 0:
                ki[name] -= 1
                if moved_ok(consumers[name] + [t]):
                    sav = base - total_cost()
                    if best is None or sav > best[0]:
                        best = (sav, "ki", name)
                ki[name] += 1
            u = ku[name]
            if (rounding_method == "exact"
                    and u < min(t.spec.shift, KEEP_MAX)):
                ku[name] = u + 1
                if moved_ok([t]):
                    sav = base - total_cost()
                    if best is None or sav > best[0]:
                        best = (sav, "ku", (name, 0))
                ku[name] = u
                # paired move: deepen keep_low while backing off the drop
                # knob of one of this decision's SOURCE TLUs (whose PBS
                # noise the window decision actually sees) — single ki
                # moves saving 1 dot each would otherwise greedily consume
                # the margin a later (larger) ku saving needs, a classic
                # greedy trap
                for src in decision_sources[name]:
                    if src == "enc" or src not in ki:
                        continue
                    for r in (1, 2):
                        if ki[src] + r > LAST:
                            break
                        ku[name] = u + 1
                        ki[src] += r
                        if moved_ok(consumers[src] + [t]):
                            sav = base - total_cost()
                            if best is None or sav > best[0]:
                                best = (sav, "ku", (name, src, r))
                        ku[name] = u
                        ki[src] -= r
        if rounding_method == "exact" and aux_ki > 0:
            aux_ki -= 1
            if moved_ok(tlus):
                sav = base - total_cost()
                if best is None or sav > best[0]:
                    best = (sav, "aux", None)
            aux_ki += 1
        if best is None or best[0] <= 0:
            break
        _, kind, name = best
        if kind == "ki":
            ki[name] -= 1
        elif kind == "ku":
            if len(name) == 2:
                name, r = name
                ku[name] += 1
            else:
                name, src, r = name
                ku[name] += 1
                ki[src] += r
        else:
            aux_ki -= 1

    aux_drop, aux_cross = (KNOB_LADDER[aux_ki]
                           if rounding_method == "exact" else (0, 0))
    res = AuditResult(params, p_error, rounding_method, aux_drop, aux_cross,
                      aux_fwd_ks_drop, aux_back_ks_drop)
    for t in tlus:
        p_w, p_x = decision_p(t)
        d, c = KNOB_LADDER[ki[t.x]]
        rep = TluReport(t.x, int(np.prod(shapes[t.x])), t.spec.in_bits,
                        t.spec.shift, d, p_w, p_x, cross=c,
                        keep_low=ku[t.x])
        res.reports.append(rep)
        res.by_acc[t.x] = rep
    return res
