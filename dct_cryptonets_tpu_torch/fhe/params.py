"""TFHE parameter sets and noise model, the port's copy of
``dct_cryptonets_tpu.fhe.params``: the same dataclasses, presets and
formulas, so that both packages pick the same lattice for a circuit and
derive the same keys from a seed.

q = 2^64; the presets follow the shape of public TFHE-rs / Concrete
parameter sets for 128-bit security (``docs/SECURITY.md`` places each
against the published contour).  ``NoiseModel`` implements the standard
CGGI noise-propagation formulas.
"""
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class TFHEParams:
    """One TFHE parameter set (q = 2^64 fixed)."""
    lwe_dim: int            # n  — small-LWE dimension (keyswitch output)
    glwe_dim: int           # k  — number of GLWE mask polynomials
    poly_size: int          # N  — polynomial degree
    pbs_base_log: int       # log2(B) gadget base for the bootstrapping key
    pbs_levels: int         # l  gadget levels for the bootstrapping key
    ks_base_log: int        # keyswitch decomposition base log
    ks_levels: int          # keyswitch decomposition levels
    lwe_noise_log2: float   # log2(sigma) of fresh small-LWE noise (absolute, q units)
    glwe_noise_log2: float  # log2(sigma) of fresh GLWE noise (absolute, q units)
    message_bits: int       # TLU precision this set is sized for (incl. sign)

    q_bits: int = 64

    @property
    def big_lwe_dim(self) -> int:
        """Dimension of the LWE sample extracted from the GLWE accumulator."""
        return self.glwe_dim * self.poly_size

    @property
    def delta_log2(self) -> int:
        """log2 of the encoding step for `message_bits` messages + 1 padding bit."""
        return self.q_bits - (self.message_bits + 1)


class NoiseModel:
    """CGGI noise-propagation estimates (variances in q^2 units, log2 domain).

    Formulas follow the TFHE/CGGI literature (blind-rotate external-product
    variance, keyswitch variance, modulus-switch variance); all in absolute
    torus units with q = 2^64.
    """

    def __init__(self, p: TFHEParams):
        self.p = p

    # -- component variances (plain float, may be large; use log2-safe math)

    def var_fresh_lwe(self) -> float:
        return 2.0 ** (2 * self.p.lwe_noise_log2)

    def var_fresh_glwe(self) -> float:
        return 2.0 ** (2 * self.p.glwe_noise_log2)

    def var_blind_rotate(self) -> float:
        """Variance added by the blind rotate (n external products)."""
        p = self.p
        n, k, N = p.lwe_dim, p.glwe_dim, p.poly_size
        B = 2.0 ** p.pbs_base_log
        l = p.pbs_levels
        q = 2.0 ** p.q_bits
        var_bsk = self.var_fresh_glwe()
        # decomposition term
        t1 = n * l * (k + 1) * N * (B * B + 2.0) / 12.0 * var_bsk
        # rounding remainder of the approximate gadget decomposition
        rem = q / (B ** l)
        t2 = n * (1.0 + k * N) / 2.0 * (rem * rem) / 12.0
        return t1 + t2

    def var_keyswitch(self) -> float:
        p = self.p
        big_n = p.big_lwe_dim
        B = 2.0 ** p.ks_base_log
        l = p.ks_levels
        q = 2.0 ** p.q_bits
        var_ksk = self.var_fresh_lwe()
        t1 = big_n * l * var_ksk * (B * B + 2.0) / 12.0
        rem = q / (B ** l)
        t2 = big_n * (rem * rem) / 24.0
        return t1 + t2

    def var_mod_switch(self) -> float:
        """Variance of the 2N modulus-switch rounding (in q^2 units)."""
        p = self.p
        step = 2.0 ** (p.q_bits - 1 - math.log2(p.poly_size))  # q / 2N
        return (p.lwe_dim / 2.0 + 1.0) * (step * step) / 12.0

    def var_pbs_output(self) -> float:
        """Noise on a freshly bootstrapped activation (KS-first order:
        the big-LWE extracted after blind rotate carries only BR noise)."""
        return self.var_blind_rotate()

    def _drop_components(self) -> float:
        """Phase-error multiplier of a BSK coefficient perturbation.

        Perturbing a GGSW by Delta (dropping low coefficient bytes) adds
        d (x) Delta to the output GLWE.  The BODY component's perturbation
        hits the phase directly (an N-term polynomial convolution); a MASK
        component's perturbation delta_a additionally convolves with the
        binary GLWE key at decryption (phase -= delta_a * s), multiplying
        its variance by ~N/2 (key density 1/2).  The old (k+1) "all
        components equal" model underestimated measured drop noise by 2^5
        in sigma at k=1/N=2048 (tools/measure_drop_noise.py on the bench
        chip: drop=3 measured 2^51.8 vs 2^46.8 modeled; this formula gives
        2^51.3).
        """
        p = self.p
        return 1.0 + p.glwe_dim * p.poly_size / 2.0

    def var_drop_cross(self, drop: int) -> float:
        """Variance added by additionally skipping the (low-digit-byte x
        lowest-kept-key-limb) products of the external product ("cross
        skip", fhe/pbs.py ``cross=1``).

        The skipped products are d0 * b_drop * 2^(8*drop) with d0 the low
        byte of a gadget digit and b the key byte at limb ``drop`` — both
        balanced bytes (var ~256^2/12).  One fewer int8 matmul per
        (row, j_out) pair per CMUX step (~11% of the blind rotate at
        drop=3).  Validated on-chip: drop=3+cross measured sigma 2^53.0
        vs 2^52.8 modeled.
        """
        p = self.p
        n, N, l = p.lwe_dim, p.poly_size, p.pbs_levels
        var_byte = (256.0 ** 2) / 12.0
        return (n * l * N * var_byte * var_byte * 2.0 ** (16 * drop)
                * self._drop_components())

    def var_drop_limbs(self, drop: int) -> float:
        """Variance added to the blind-rotate output by skipping the low
        ``drop`` BSK byte limbs in the external product (throughput mode).

        Each dropped (digit, key-byte) product contributes
        d * b * 2^(8v) with d a balanced gadget digit (var (B^2+2)/12) and
        b a balanced byte (var ~256^2/12), summed over the n CMUX steps,
        l gadget levels, N polynomial positions, and the component factor
        of :meth:`_drop_components`.  Validated on-chip: drop=3 measured
        sigma 2^51.8 vs 2^51.3 modeled (constant-table isolation,
        tools/measure_drop_noise.py).
        """
        p = self.p
        n, N, l = p.lwe_dim, p.poly_size, p.pbs_levels
        var_digit = (2.0 ** (2 * p.pbs_base_log) + 2.0) / 12.0
        var_byte = (256.0 ** 2) / 12.0
        scale = sum(2.0 ** (16 * v) for v in range(drop))
        return (n * l * N * var_digit * var_byte * scale
                * self._drop_components())

    @staticmethod
    def var_ks_drop(rows: int, n_dst: int, base_log: int, drop: int) -> float:
        """Variance added by skipping the low ``drop`` byte limbs of a
        keyswitch key in :func:`~.pbs.lwe_key_switch`.

        Each skipped (digit, KSK-byte) product perturbs the output by
        d * delta with d a gadget digit of the decomposed input
        (var (B^2+2)/12) and delta a balanced byte at scale 2^(8v).
        Perturbing a MASK coordinate of a KSK row additionally convolves
        with the destination binary key at decryption (n_dst/2 terms),
        the same mechanism as :meth:`_drop_components`.
        """
        var_digit = (2.0 ** (2 * base_log) + 2.0) / 12.0
        var_byte = (256.0 ** 2) / 12.0
        scale = sum(2.0 ** (16 * v) for v in range(drop))
        return rows * var_digit * var_byte * scale * (1.0 + n_dst / 2.0)

    # -- error probability

    def pbs_error_probability(self, message_bits: int,
                              input_variance: float | None = None) -> float:
        """P(the PBS reads a wrong table window) for `message_bits` TLUs.

        The decision margin is half the encoding window, q / 2^(bits+2);
        decision-time noise = (amplified) input noise + keyswitch noise +
        mod-switch noise (KS -> MS -> BR pipeline order).
        """
        p = self.p
        margin = 2.0 ** (p.q_bits - (message_bits + 2))
        var = self.var_mod_switch() + self.var_keyswitch()
        if input_variance is not None:
            var += input_variance
        sigma = math.sqrt(var)
        z = margin / sigma
        return math.erfc(z / math.sqrt(2.0))

    def max_input_std_for(self, message_bits: int, p_error: float) -> float:
        """Largest input-noise std tolerable for a target per-PBS p_error."""
        import scipy.stats as st
        margin = 2.0 ** (self.p.q_bits - (message_bits + 2))
        z = st.norm.isf(p_error / 2.0)
        total_var = (margin / z) ** 2
        slack = total_var - self.var_mod_switch() - self.var_keyswitch()
        return math.sqrt(max(slack, 0.0))


# ---------------------------------------------------------------------------
# presets

# Shapes follow public TFHE-rs/Concrete 128-bit parameter sets for q = 2^64.
# Gadget base 2^15 with 2 levels is the 2-int8-byte-digit sweet spot: digits
# lie in [-2^14, 2^14] (torus.decompose), which still fits two balanced byte
# limbs in the int8 external product at the SAME MAC cost as smaller bases,
# while the decomposition remainder (std ~ q / B^l = 2^34) is 4 bits lower
# than base 2^13 — directly shrinking the blind-rotate output noise that
# consumer convs amplify (the JAX package's fhe/noise_audit.py).  Base 2^16
# would overflow the two-byte digit range by its single +B/2 boundary value.
_PRESETS = {
    # message_bits (incl. sign of the rounded accumulator) -> params
    4: TFHEParams(lwe_dim=742, glwe_dim=1, poly_size=1024,
                  pbs_base_log=15, pbs_levels=2, ks_base_log=4, ks_levels=6,
                  lwe_noise_log2=46.0, glwe_noise_log2=14.0, message_bits=4),
    5: TFHEParams(lwe_dim=776, glwe_dim=1, poly_size=2048,
                  pbs_base_log=15, pbs_levels=2, ks_base_log=4, ks_levels=6,
                  lwe_noise_log2=45.5, glwe_noise_log2=12.0, message_bits=5),
    # Small-LWE pair (776, sigma 2^45.5) — preset-5's published-shape
    # pair — instead of the (840, 2^44) of earlier rounds: 7.6% fewer CMUX
    # steps per PBS, and with a finer keyswitch decomposition (base 2^2 x
    # 12; KS MACs < 0.1% of a PBS) the keyswitch variance (~2^106.2) plus
    # the smaller-n mod-switch variance land slightly BELOW the old
    # (840, ks 2^3x8) fixed-noise floor.  The published anchor (742,
    # 2^46.3) was evaluated and rejected: its keyswitch noise alone eats
    # the whole r=6 window budget (floor p > 0.01).
    6: TFHEParams(lwe_dim=776, glwe_dim=1, poly_size=2048,
                  pbs_base_log=15, pbs_levels=2, ks_base_log=2, ks_levels=12,
                  lwe_noise_log2=45.5, glwe_noise_log2=12.0, message_bits=6),
    7: TFHEParams(lwe_dim=970, glwe_dim=1, poly_size=4096,
                  pbs_base_log=15, pbs_levels=2, ks_base_log=3, ks_levels=8,
                  lwe_noise_log2=41.5, glwe_noise_log2=12.0, message_bits=7),
    8: TFHEParams(lwe_dim=1024, glwe_dim=1, poly_size=8192,
                  pbs_base_log=15, pbs_levels=2, ks_base_log=3, ks_levels=8,
                  lwe_noise_log2=40.0, glwe_noise_log2=12.0, message_bits=8),
}

# Extraction parameter sets (exact-rounding LSB bootstraps).  A sign
# bootstrap's decision margin is a quarter torus — orders of magnitude wider
# than any message-carrying TLU's window — so the extraction lattice can be
# far smaller than the message presets.  The same-security ladder keeps the
# total GLWE dimension k*N = 1024 at sigma 2^14 (preset-4's GLWE) but trades
# polynomial size for more mask polynomials: blind-rotate matmul work scales
# as n * (k+1)^2 * l * N^2, so k=4/N=256 runs ~3x cheaper than k=1/N=1024 at
# unchanged security and unchanged extracted-bit output noise (the
# decomposition-remainder term n*(1+kN)/2*(q/B^l)^2/12 depends only on kN).
# The small-LWE pair (n=630, sigma 2^49, i.e. sigma/q = 2^-15) follows the
# published TFHE-rs 128-bit shape for that dimension.
EXTRACT_PRESETS = {
    "k4n256": TFHEParams(lwe_dim=630, glwe_dim=4, poly_size=256,
                         pbs_base_log=15, pbs_levels=2, ks_base_log=4,
                         ks_levels=6, lwe_noise_log2=49.0,
                         glwe_noise_log2=14.0, message_bits=1),
    "k2n512": TFHEParams(lwe_dim=630, glwe_dim=2, poly_size=512,
                         pbs_base_log=15, pbs_levels=2, ks_base_log=4,
                         ks_levels=6, lwe_noise_log2=49.0,
                         glwe_noise_log2=14.0, message_bits=1),
    # Noisier/smaller small-LWE pair for the same GLWE: a sign bootstrap's
    # decision margin is a quarter torus (2^62), so the small key can carry
    # sigma/q = 2^-12 — letting n shrink to 512 on the same 128-bit contour
    # (n scales ~linearly with log2(q/sigma); anchors (742, 17.7) and
    # (630, 15) give ~42 n per bit -> 12 bits ~ 504; see docs/SECURITY.md,
    # estimator-validation flag applies).  The noisier key needs a finer
    # forward-keyswitch decomposition (base 2^2 x 12: sigma_ks ~ 2^58.8
    # for kN_main=2048 rows, ~9 sigma under the quarter-torus margin;
    # base 2^4 x 6 would sit at only ~2 sigma) — keyswitch MACs are <1%
    # of the blind rotate, so the extra levels are free.  20% fewer CMUX
    # steps per extraction than k2n512.
    "k2n512f": TFHEParams(lwe_dim=512, glwe_dim=2, poly_size=512,
                          pbs_base_log=15, pbs_levels=2, ks_base_log=2,
                          ks_levels=12, lwe_noise_log2=52.0,
                          glwe_noise_log2=14.0, message_bits=1),
    # the pre-ladder baseline (preset-4 geometry with the cheap small-LWE
    # pair); kept for measurement comparison
    "k1n1024": TFHEParams(lwe_dim=630, glwe_dim=1, poly_size=1024,
                          pbs_base_log=15, pbs_levels=2, ks_base_log=4,
                          ks_levels=6, lwe_noise_log2=49.0,
                          glwe_noise_log2=14.0, message_bits=1),
}
DEFAULT_EXTRACT = "k2n512f"

# Tiny insecure parameters for fast unit tests of the runtime mechanics.
TEST_PARAMS = TFHEParams(lwe_dim=16, glwe_dim=1, poly_size=256,
                         pbs_base_log=15, pbs_levels=2, ks_base_log=4,
                         ks_levels=4, lwe_noise_log2=10.0, glwe_noise_log2=4.0,
                         message_bits=4)

# Tiny k>1 set: exercises the multi-mask-polynomial engine paths in CI.
TEST_PARAMS_K2 = TFHEParams(lwe_dim=16, glwe_dim=2, poly_size=256,
                            pbs_base_log=15, pbs_levels=2, ks_base_log=4,
                            ks_levels=4, lwe_noise_log2=10.0,
                            glwe_noise_log2=4.0, message_bits=4)


def safe_drop_limbs(p: TFHEParams, message_bits: int,
                    p_error: float = 0.01,
                    amplification2: float = 2.0 ** 14) -> int:
    """Largest BSK byte-limb drop whose extra external-product noise keeps
    the per-PBS error probability within ``p_error`` (the preset contract).

    Dropping low key limbs cuts the blind-rotate MAC count by 1/8 each.
    The dropped-limb noise sits on the PBS *output* ciphertext, so the next
    TLU's decision sees it amplified by the consumer conv's squared-weight
    sum, ``amplification2`` (default conservative for the reference nets'
    int4 3x3 convs; the circuit noise audit, ``fhe/noise_audit.py``,
    computes the exact per-layer value).
    """
    nm = NoiseModel(p)
    for d in range(7, -1, -1):
        var_out = nm.var_drop_limbs(d) + nm.var_blind_rotate()
        if nm.pbs_error_probability(
                message_bits,
                input_variance=var_out * amplification2) <= p_error:
            return d
    return 0


def params_for_precision(message_bits: int) -> TFHEParams:
    """Smallest preset that supports `message_bits` TLUs."""
    for b in sorted(_PRESETS):
        if b >= message_bits:
            return _PRESETS[b]
    raise ValueError(f"no parameter set for {message_bits}-bit TLUs (max 8)")


# ---------------------------------------------------------------------------
# exact rounding (Concrete's default `rounding_threshold_bits` method)


@dataclass(frozen=True)
class ExactRoundingConfig:
    """Parameters of the LSB-extraction pipeline (fhe.pbs.clear_low_bits).

    ``aux`` is the cheap parameter set the per-bit sign bootstraps run on
    (small N — each extraction costs ~(n_aux/n)*(N_aux/N)^2 of a main PBS);
    ``back_base_log/levels`` decompose the aux-big -> main-big keyswitch.
    """
    aux: TFHEParams
    back_base_log: int = 4
    back_levels: int = 6


def default_exact_rounding(main: TFHEParams,
                           p_error: float = 0.01,
                           extract: str | None = None) -> ExactRoundingConfig:
    """Pick an extraction config for a main parameter set.

    The aux set comes from ``EXTRACT_PRESETS`` (small-N / multi-mask GLWE —
    see the table above); the sign decision has a quarter-torus margin
    (2^62), so the aux set's KS+MS noise (~2^57) gives an extraction slip
    probability that is negligible next to any practical per-PBS
    ``p_error`` contract — asserted here via the noise model.  Test-scale
    main sets (tiny insecure N) reuse themselves as the aux set so unit
    tests don't pay production keygen.
    """
    if main.poly_size <= 512 and main.lwe_dim < 256:
        candidates = [main]                  # tiny test sets reuse themselves
    elif extract is not None:
        candidates = [EXTRACT_PRESETS[extract]]
    else:
        # fastest first; the noisier small key of the fast set fails the
        # slip check against very large main keys (kN_main rows amplify
        # its fresh noise through the forward keyswitch), where the
        # conservative set takes over
        candidates = [EXTRACT_PRESETS[DEFAULT_EXTRACT],
                      EXTRACT_PRESETS["k2n512"]]
    last = None
    for aux in candidates:
        nm = NoiseModel(aux)
        # forward keyswitch from the main big key: kN_main rows
        big_n = main.glwe_dim * main.poly_size
        B = 2.0 ** aux.ks_base_log
        l = aux.ks_levels
        q = 2.0 ** aux.q_bits
        var_ks = (big_n * l * nm.var_fresh_lwe() * (B * B + 2.0) / 12.0
                  + big_n * (q / B ** l) ** 2 / 24.0)
        margin = 2.0 ** (aux.q_bits - 2)            # quarter torus
        sigma = math.sqrt(nm.var_mod_switch() + var_ks)
        slip = math.erfc(margin / sigma / math.sqrt(2.0))
        if slip <= p_error * 1e-2:
            return ExactRoundingConfig(aux)
        last = slip
    raise ValueError(
        f"extraction aux set infeasible for this p_error (slip {last:.2e})")
