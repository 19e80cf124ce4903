"""The rounding argument of the packed bfloat16 kernels, on the CPU.

The bfloat16 Jacobi ring (K2, B6) and B8 add and multiply with Hopper's
``add.rn.bf16x2`` / ``mul.rn.bf16x2`` (``add.rn.bf16`` / ``mul.rn.bf16``
for single cells): one rounding to nearest even of the EXACT result. Their
plain twins, like the JAX kernels, do each operation in float32 and round
that to bfloat16 (PyTorch's bfloat16 ``+`` and ``*``). The kernels agree
with the twins bitwise only if the two roundings always agree
(csrc/bf16_math.cuh gives the argument). This holds them to each other:
the exact result is an integer significand times a power of two, rounded
here to bfloat16 with integers alone, against torch's bfloat16 ``+`` and
``*`` on the CPU, compared as bits, on

- a structured set of pairs: every exponent (subnormals and ±0 among
  them), each against partners 0, 1, 8, 16 and 30 binades apart, in all
  four sign combinations; ties to even; random pairs from a seed;
- the multiplication by bf16(1/6) (0x3E2B) of every finite bfloat16.

Runtime: about 2 s in all on one core.
"""

import numpy as np
import pytest
import torch

SIXTH = 0x3E2B  # bf16(1/6), the Jacobi kernels' constant
INF = 0x7F80


def _finite(bits: np.ndarray) -> np.ndarray:
    return bits[(bits & 0x7F80) != 0x7F80]


def _decode(b: int):
    """(sign, M, E): the finite bfloat16 with bits ``b`` is (-1)^sign * M
    * 2^E, M an integer (the 8-bit significand, 7 bits for subnormals)."""
    s, e, f = b >> 15, (b >> 7) & 0xFF, b & 0x7F
    if e == 0:
        return s, f, -133
    return s, 128 | f, e - 134


def _round(sign: int, n: int, e: int) -> int:
    """The bits of (-1)^sign * n * 2^e (n >= 0) rounded once to nearest
    even bfloat16 (overflow to infinity)."""
    if n == 0:
        return sign << 15
    top = n.bit_length() - 1 + e  # the value lies in [2^top, 2^(top+1))
    q = max(top - 7, -133)        # the bfloat16 quantum's exponent there
    shift = q - e
    if shift <= 0:
        m = n << -shift
    else:
        m, rem = n >> shift, n & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and m & 1):
            m += 1
    if m == 256:  # the rounding carried into the next binade
        m, q = 128, q + 1
    if m < 128:   # subnormal (q == -133)
        return (sign << 15) | m
    exp = q + 134
    if exp >= 255:
        return (sign << 15) | INF
    return (sign << 15) | (exp << 7) | (m - 128)


def exact_sum(a: int, b: int) -> int:
    sa, ma, ea = _decode(a)
    sb, mb, eb = _decode(b)
    e = min(ea, eb)
    n = (-1) ** sa * (ma << (ea - e)) + (-1) ** sb * (mb << (eb - e))
    if n == 0:  # x + (-x) is +0 to nearest; -0 + -0 is -0
        return 0x8000 if (sa and sb) else 0
    return _round(int(n < 0), abs(n), e)


def exact_product(a: int, b: int) -> int:
    sa, ma, ea = _decode(a)
    sb, mb, eb = _decode(b)
    return _round(sa ^ sb, ma * mb, ea + eb)


def _bf16(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint16)
                            .view(np.int16)).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _check(a, b, op):
    """torch's bfloat16 op (float32, then rounded) against the exact
    result rounded once, bit for bit."""
    a = np.asarray(a, dtype=np.uint16)
    b = np.asarray(b, dtype=np.uint16)
    ta, tb = _bf16(a), _bf16(b)
    got = _bits(ta + tb if op == "add" else ta * tb)
    ref = exact_sum if op == "add" else exact_product
    want = np.array([ref(int(x), int(y)) for x, y in zip(a, b)],
                    dtype=np.uint16)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, [(hex(a[i]), hex(b[i]), hex(got[i]),
                            hex(want[i])) for i in bad[:5]]


def _pairs(apart: int):
    """Every biased exponent 0..254 with four significands (0, 1, 0x40,
    0x7F), each against the partner ``apart`` binades above (clipped to
    the finite range), all four sign combinations."""
    a, b = [], []
    for e in range(255):
        eb = min(e + apart, 254)
        for fa in (0, 1, 0x40, 0x7F):
            for fb in (0, 0x55, 0x7F):
                for sa in (0, 1):
                    for sb in (0, 1):
                        a.append((sa << 15) | (e << 7) | fa)
                        b.append((sb << 15) | (eb << 7) | fb)
    return a, b


@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("apart", [0, 1, 8, 16, 30])
def test_one_rounding_equals_float32_then_bf16_on_every_exponent(apart, op):
    a, b = _pairs(apart)
    _check(a, b, op)
    _check(b, a, op)


def test_reference_rounds_ties_to_even():
    # 1 + 2^-8 is half an ulp above 1: to even, 1; (1 + 2^-7) + 2^-8 is
    # half an ulp above an odd significand: up, to 1 + 2^-6
    assert exact_sum(0x3F80, 0x3B80) == 0x3F80
    assert exact_sum(0x3F81, 0x3B80) == 0x3F82
    # the largest finite plus half its ulp ties to even: infinity
    assert exact_sum(0x7F7F, 0x7B00) == INF
    assert exact_sum(0xFF7F, 0xFB00) == 0x8000 | INF
    # the smallest subnormal times one half ties to even: zero
    assert exact_product(0x0001, 0x3F00) == 0x0000
    assert exact_product(0x0003, 0x3F00) == 0x0002


@pytest.mark.parametrize("op", ["add", "mul"])
def test_one_rounding_equals_float32_then_bf16_on_ties(op):
    # operands whose exact result lies halfway between two bfloat16
    # values, in every binade: significands odd and even below a half-ulp
    # partner (add), and a 9-bit exact product (mul: 1.5 * odd)
    a, b = [], []
    for e in range(8, 247):
        for f in (0, 1, 2, 3, 0x7E, 0x7F):
            for s in (0, 1):
                x = (s << 15) | (e << 7) | f
                if op == "add":
                    a.append(x)
                    b.append((s << 15) | ((e - 8) << 7))
                else:
                    a.append(x)
                    b.append(0x3FC0)  # 1.5
    _check(a, b, op)


@pytest.mark.parametrize("op", ["add", "mul"])
def test_one_rounding_equals_float32_then_bf16_on_subnormals_and_zeros(op):
    small = [0x0000, 0x8000, 0x0001, 0x8001, 0x0040, 0x807F, 0x007F,
             0x0080, 0x8080, 0x00FF, 0x0100, 0x3F80, 0xBF80, 0x3400, 0x4B00]
    a = [x for x in small for _ in small]
    b = [y for _ in small for y in small]
    _check(a, b, op)


@pytest.mark.parametrize("op", ["add", "mul"])
def test_one_rounding_equals_float32_then_bf16_on_random_pairs(op):
    g = np.random.default_rng(2025)
    a = _finite(g.integers(0, 1 << 16, 40_000, dtype=np.uint32)
                .astype(np.uint16))
    b = _finite(g.integers(0, 1 << 16, 40_000, dtype=np.uint32)
                .astype(np.uint16))
    n = min(a.size, b.size)
    _check(a[:n], b[:n], op)


def test_multiplying_every_finite_bf16_by_a_sixth_rounds_once():
    every = _finite(np.arange(1 << 16, dtype=np.uint32).astype(np.uint16))
    assert every.size == 65536 - 2 * 128  # less infinities and NaNs
    _check(every, np.full_like(every, SIXTH), "mul")
