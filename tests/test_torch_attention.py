"""The folded causal attention of the port (repro_torch.kernels.
folded_attention, ops.attention) against the reference package on
identical inputs, and the LM prefill's padded call of it.

On the CPU the wrapper runs the kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as the reference's own tests
do.  Tolerances are the reference's (tests/test_kernels.py): 2e-4 in
f32, 3e-2 in bf16 (the output is rounded to bf16, and the kernel rounds
p to bf16 before P V).  The two schedules must agree bit for bit
(torch.equal): both run each q-block through the same block step in the
same order.  The CUDA kernel itself is held against this plain version
on the card by chip_smoke.py (phase 7)."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import folded_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import folded_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, Hq, Hkv, S, D, seed, scales=(0.5, 0.5, 1.0)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, H, S, D)) * s).astype(np.float32)
            for H, s in zip((Hq, Hkv, Hkv), scales)]


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    j = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("S,bq", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_attention_sweep_matches_reference(S, bq, Hq, Hkv):
    """tests/test_kernels.py::test_folded_attention_sweep's cases: the
    port's plain version against the Pallas kernel and both oracles."""
    arrays = _qkv(2, Hq, Hkv, S, 32, seed=S + bq + Hkv)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    got = tops.attention(tq, tk, tv, bq=bq, bk=bq).numpy()
    _close(got, jops.attention(jq, jk, jv, bq=bq, bk=bq), TOL["float32"])
    _close(got, jref.attention_ref(jq, jk, jv), TOL["float32"])
    _close(tref.attention_ref(tq, tk, tv).numpy(),
           jref.attention_ref(jq, jk, jv), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dtypes_match_reference(dtype):
    """tests/test_kernels.py::test_folded_attention_dtypes' case."""
    arrays = _qkv(1, 2, 2, 64, 64, seed=7, scales=(0.3, 0.3, 1.0))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    got = tops.attention(tq, tk, tv, bq=16, bk=16)
    assert got.dtype == TDT[dtype]
    got = got.float().numpy()
    _close(got, jops.attention(jq, jk, jv, bq=16, bk=16).astype(jnp.float32),
           TOL[dtype])
    _close(got, jref.attention_ref(jq, jk, jv).astype(jnp.float32),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,S,D,bq", [(2, 2, 128, 32, 16),
                                           (9, 3, 256, 64, 64),
                                           (4, 2, 64, 36, 16)])
def test_folded_equals_naive(dtype, Hq, Hkv, S, D, bq):
    """Both schedules give the same bits; folded runs the triangle's
    Qb(Qb+1)/2 of the reference's Qb^2 grid slots."""
    _, (q, k, v) = _both(_qkv(2, Hq, Hkv, S, D, seed=S + D), dtype)
    out_f = tops.attention(q, k, v, bq=bq, bk=bq, schedule="folded")
    out_n = tops.attention(q, k, v, bq=bq, bk=bq, schedule="naive")
    assert torch.equal(out_f, out_n)
    qb = S // bq
    assert tfa.grid_slots(S, bq, "folded") == qb * (qb + 1) // 2 \
        < tfa.grid_slots(S, bq, "naive") == qb * qb


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["odd_blocks", "heads", "bq_bk", "S_bq",
                                  "schedule"])
def test_errors_match_reference(case):
    """The reference's checks, with its messages
    (tests/test_kernels.py::test_folded_attention_rejects_odd_blocks and
    the other ValueErrors of folded_causal_attention)."""
    shapes, kw = {
        "odd_blocks": (((1, 1, 48, 16),) * 3, dict(bq=16, bk=16)),
        "heads": (((1, 3, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16)),
                  dict(bq=16, bk=16)),
        "bq_bk": (((1, 1, 64, 16),) * 3, dict(bq=16, bk=32)),
        "S_bq": (((1, 1, 40, 16),) * 3, dict(bq=16, bk=16)),
        "schedule": (((1, 1, 32, 16),) * 3,
                     dict(bq=16, bk=16, schedule="zigzag")),
    }[case]
    arrays = [np.zeros(s, np.float32) for s in shapes]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    want = _message(lambda: jops.attention(jq, jk, jv, **kw))
    got = _message(lambda: tops.attention(tq, tk, tv, **kw))
    assert got == want
    if case == "odd_blocks":
        assert "even number of q-blocks" in got


def test_grid_slots_match_reference():
    """benchmarks/kernel_schedule.py's grid (S, bq = 256) and more."""
    for S in (2048, 4096, 8192, 32768):
        for bq in (16, 64, 128, 256):
            for schedule in ("folded", "naive"):
                assert tfa.grid_slots(S, bq, schedule) == \
                    jfa.grid_slots(S, bq, schedule)


@pytest.mark.parametrize("qb_count", [2, 4, 16])
def test_schedule_order_runs_every_qblock_once(qb_count):
    for schedule in ("folded", "naive"):
        order = tfa.schedule_order(qb_count, schedule)
        assert sorted(sum(order, [])) == list(range(qb_count))
    steps = [sum(qb + 1 for qb in blocks)
             for blocks in tfa.schedule_order(qb_count, "folded")]
    assert steps == [qb_count + 1] * (qb_count // 2)   # balanced


def test_strided_views_need_no_copy():
    """(B, S, H, D) projections pass as transposed views; the output's
    transpose back is contiguous and the values equal the contiguous
    call's."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 64, 4, 32), generator=g)
    k = torch.randn((2, 64, 2, 32), generator=g)
    v = torch.randn((2, 64, 2, 32), generator=g)
    args = [t.transpose(1, 2) for t in (q, k, v)]
    out = tops.attention(*args, bq=16, bk=16)
    assert out.transpose(1, 2).is_contiguous()
    assert torch.equal(out, tops.attention(
        *(a.contiguous() for a in args), bq=16, bk=16))


def test_kernel_operand_checks():
    """What the CUDA kernel does not take raises before any launch."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)
    q, kv = t(8, 9, 2048, 64), t(8, 3, 2048, 64)
    tfa.check_kernel_operands(q, kv, kv, 128)           # the serving shape
    for args, bq, what in (
            ((t(1, 2, 64, 48), t(1, 2, 64, 48), t(1, 2, 64, 48)), 16,
             "head width"),
            ((q, kv, kv), 8, "bq in"),
            ((q.double(), kv.double(), kv.double()), 128, "float32 or"),
            ((q, kv.float(), kv), 128, "float32 or"),
            ((q, t(8, 3, 1024, 64), kv), 128, "k, v must be")):
        with pytest.raises(ValueError, match=what):
            tfa.check_kernel_operands(*args, bq)


@pytest.mark.parametrize("S", [1, 17, 40, 64, 300])
def test_prefill_attention_padding_matches_chunked(S):
    """The LM prefill's call: S padded at the tail to 2 bq, the padded
    rows sliced off, against the reference model's _chunked_causal on the
    unpadded (B, S, H, D) inputs (reduced smollm's GQA 4/2, D = 36)."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(2, S, H, 36)).astype(np.float32)
               for H in (4, 2, 2))
    want = jattn._chunked_causal(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), chunk=32, window=0,
                                 softcap_val=0.0, scale=1.0 / np.sqrt(36))
    got = tattn.prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (2, S, 4, 36)
    _close(got.numpy(), want, TOL["float32"])
    bq = tattn.attention_block(S)
    assert bq in tfa.KERNEL_BQ and -(-S // (2 * bq)) * 2 * bq - S < 2 * bq


def test_attention_block_sizes():
    assert [tattn.attention_block(S) for S in (1, 32, 33, 64, 65, 256, 2048,
                                               4096)] == \
        [16, 16, 32, 32, 64, 128, 128, 128]


def _chip_smoke():
    """chip_smoke.py as a module (its functions import torch lazily)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,fault", [
    ("bfloat16", None), ("bfloat16", "p_unrounded"),
    ("bfloat16", "diagonal_dropped"), ("float32", None),
    ("float32", "tf32_scores"), ("float32", "diagonal_dropped")])
def test_chip_limits_separate_sound_from_planted(dtype, fault):
    """chip_smoke.py's ATTN_TOL holds the CUDA kernel to its plain version
    on the card.  Here the Pallas kernel (interpret mode), a second sound
    implementation, passes it against the port's plain version, and each
    fault planted in the plain version (chip_smoke.ATTN_FAULTS) breaks
    it."""
    cs = _chip_smoke()
    assert fault is None or fault in cs.ATTN_FAULTS[dtype]
    arrays = _qkv(2, 4, 2, 256, 36, seed=11)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    jout = np.asarray(jops.attention(jq, jk, jv, bq=32, bk=32)
                      .astype(jnp.float32))
    got = torch.from_numpy(jout.copy()).to(TDT[dtype])
    want = (tops.attention(tq, tk, tv, bq=32, bk=32) if fault is None else
            cs.planted_attention(tq, tk, tv, bq=32, bk=32, fault=fault))
    r, tol = cs.attention_readings(got, want), cs.ATTN_TOL[dtype]
    passes = r["elem"] <= tol["elem"] and r["l2"] <= tol["l2"]
    assert passes == (fault is None), r


def _rtz_f32(x):
    """f64 x rounded toward zero to f32."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _mma_steps(a, b, c=None):
    """a @ b as mma.sync forms it: over k-steps of 16, the exact sum of
    the running f32 sum and the step's 16 products (here in f64), rounded
    toward zero to f32 (the card's rounding of its f32 sums)."""
    for k0 in range(0, a.shape[-1], 16):
        part = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
        c = _rtz_f32(part if c is None else c.double() + part)
    return c


def _mma_emulation(q, k, v, *, bq, scale):
    """The bf16 CUDA kernel's arithmetic in torch: per q-block of bq rows,
    one online-softmax step per kv block of bq keys; q k^T through
    _mma_steps over d; the softmax in base 2 (the scores times scale
    log2(e), rounded to f32; p = exp2(s - m)), l * alpha + rowsum(p) from
    the f32 p, p rounded to bf16; the block's P V through _mma_steps over
    keys from zero, added to acc * alpha in round-to-nearest; the output
    acc / l rounded to bf16."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qf = q.float().unflatten(1, (Hkv, Hq // Hkv))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    scale2 = torch.tensor(scale) * torch.tensor(1.4426950408889634)
    out = torch.empty_like(qf)
    for qb in range(S // bq):
        rows = slice(qb * bq, (qb + 1) * bq)
        qs = qf[:, :, :, rows]
        m = torch.full(qs.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qs)
        for kv in range(qb + 1):
            cols = slice(kv * bq, (kv + 1) * bq)
            kt, vt = kf[..., cols, :], vf[..., cols, :]
            s = _mma_steps(qs, kt.transpose(-1, -2)) * scale2
            if kv == qb:
                upper = torch.ones((bq, bq), dtype=torch.bool).triu(1)
                s = s.masked_fill(upper, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mma_steps(p.to(torch.bfloat16).float(), vt)
            m = m_new
        out[:, :, :, rows] = acc / l
    return out.flatten(1, 2).to(q.dtype)


@pytest.mark.parametrize("fault", [None, "p_unrounded", "diagonal_dropped"])
@pytest.mark.parametrize("D", [64, 36])
def test_mma_arithmetic_within_chip_limits(D, fault):
    """The bf16 kernel's tensor-core arithmetic (_mma_emulation), at the
    serving GQA layout (Hq 9, Hkv 3, bq 128) cut to B 1, S 256, passes
    chip_smoke.ATTN_TOL against the plain version, and each planted fault
    of chip_smoke.ATTN_FAULTS still breaks the limit: the limit holds a
    kernel with the card's rounding and still rejects a faulty one."""
    cs = _chip_smoke()
    assert fault is None or fault in cs.ATTN_FAULTS["bfloat16"]
    _, (q, k, v) = _both(_qkv(1, 9, 3, 256, D, seed=D), "bfloat16")
    scale = float(1.0 / D ** 0.5)
    got = _mma_emulation(q, k, v, bq=128, scale=scale)
    want = (tops.attention(q, k, v, bq=128, bk=128) if fault is None else
            cs.planted_attention(q, k, v, bq=128, bk=128, fault=fault))
    r, tol = cs.attention_readings(got, want), cs.ATTN_TOL["bfloat16"]
    passes = r["elem"] <= tol["elem"] and r["l2"] <= tol["l2"]
    assert passes == (fault is None), r
    if fault is None:
        assert not torch.equal(got, want)   # the sums' order does differ


# ---------------------------------------------------------------------------
# the attention mixer's other layers: window, soft cap, M-RoPE
# ---------------------------------------------------------------------------

def _mixer_pair(arch, seed, **over):
    """The reference's attn params of reduced ``arch`` (with ``over``)
    and the port's Attention module holding them."""
    import dataclasses
    import jax
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    cj = dataclasses.replace(jconfigs.reduced(arch), **over)
    ct = dataclasses.replace(tconfigs.reduced(arch), **over)
    p = jattn.attn_init(jax.random.key(seed), cj, jnp.float32)
    window = ct.window                  # > 0 only for recurrentgemma
    mod = tattn.Attention(ct, torch.float32, window=window)
    for name, a in p.items():
        getattr(mod, name).data.copy_(torch.from_numpy(np.array(a)))
    return cj, ct, p, mod, window


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,over", [
    ("recurrentgemma-9b", {}),                      # window 32, softcap 30
    ("recurrentgemma-9b", {"logit_softcap": 0.0}),  # window only
    ("gemma-7b", {"logit_softcap": 30.0}),          # softcap only
    ("qwen2-vl-7b", {}),                            # M-RoPE, kernel layers
])
def test_mixer_prefill_and_decode_match_reference(arch, over):
    """Prefill output and cache, then decode past the window (the ring
    wraps: prompt 40, 12 steps, window 32) against the reference's
    attn_apply / _block_prefill's cache / decode_step.  Windowed and
    soft-capped layers run chunked_causal; plain ones the kernel's plain
    version (uses_kernel)."""
    cj, ct, p, mod, window = _mixer_pair(arch, 5, **over)
    assert mod.uses_kernel == (not window and not ct.logit_softcap)
    rng = np.random.default_rng(6)
    Bx, S, steps = 2, 40, 12
    x = rng.normal(size=(Bx, S, ct.d_model)).astype(np.float32)
    if ct.pos_type == "mrope":
        pos = np.stack([np.tile(np.arange(S), (Bx, 1)) + i
                        for i in range(3)]).astype(np.int32)
    else:
        pos = np.tile(np.arange(S, dtype=np.int32), (Bx, 1))
    want = jattn.attn_apply(p, jnp.asarray(x), cj, jnp.asarray(pos),
                            window=window)
    max_len = S + steps
    got, cache = mod.prefill(torch.from_numpy(x), torch.from_numpy(pos),
                             max_len, torch.float32)
    assert _rel_err(got.numpy(), want) < TOL["float32"]
    L = min(window, max_len) if window else max_len
    assert cache["k"].shape == (Bx, L, ct.num_kv_heads, ct.head_dim)
    jcache = jattn.cache_init(cj, Bx, max_len, jnp.float32, window=window)
    _, k, v = jattn._project(p, jnp.asarray(x), cj, jnp.asarray(pos))
    if window:     # the reference prefill's ring order: p at slot p % L
        jcache = {"k": jnp.roll(k[:, S - L:], S % L, axis=1),
                  "v": jnp.roll(v[:, S - L:], S % L, axis=1)}
    else:
        jcache = {"k": jcache["k"].at[:, :S].set(k),
                  "v": jcache["v"].at[:, :S].set(v)}
    for key in ("k", "v"):
        assert _rel_err(cache[key].numpy(), jcache[key]) < TOL["float32"]
    for i in range(steps):
        x1 = rng.normal(size=(Bx, 1, ct.d_model)).astype(np.float32)
        jout, jcache = jattn.decode_step(p, jnp.asarray(x1), cj, jcache,
                                         jnp.int32(S + i), window=window)
        tout, cache = mod.decode_step(torch.from_numpy(x1), cache, S + i)
        assert _rel_err(tout.numpy(), jout) < TOL["float32"], i
    for key in ("k", "v"):
        assert _rel_err(cache[key].numpy(), jcache[key]) < TOL["float32"]


@pytest.mark.parametrize("window,softcap,S", [(16, 0.0, 50), (0, 20.0, 37),
                                              (8, 30.0, 64), (64, 0.0, 20)])
def test_chunked_causal_matches_reference(window, softcap, S):
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.normal(size=(2, S, H, 16)).astype(np.float32)
               for H in (4, 2, 2))
    kw = dict(chunk=16, window=window, softcap_val=softcap, scale=0.25)
    want = jattn._chunked_causal(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    got = tattn.chunked_causal(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    _close(got.numpy(), want, TOL["float32"])


def test_local_cache_init_is_the_ring():
    import dataclasses
    from repro_torch import configs as tconfigs
    cfg = dataclasses.replace(tconfigs.reduced("recurrentgemma-9b"))
    assert tattn.cache_init(cfg, 2, 100, torch.float32, window=32)["k"] \
        .shape[1] == 32
    assert tattn.cache_init(cfg, 2, 20, torch.float32, window=32)["k"] \
        .shape[1] == 20
    assert tattn.cache_init(cfg, 2, 100, torch.float32)["k"].shape[1] == 100


# ---------------------------------------------------------------------------
# head widths 192 and 256 (gemma-7b, nemotron-4-340b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 4, 256), (6, 2, 192)])
def test_wide_heads_match_reference(dtype, Hq, Hkv, D):
    """The plain version at D = 192 / 256 and the kernel's largest block
    there (max_bq: 64) against the Pallas kernel in interpret mode and the
    reference's oracle, at small S."""
    bq = tfa.max_bq(D)
    assert bq == 64
    arrays = _qkv(1, Hq, Hkv, 128, D, seed=D, scales=(0.3, 0.3, 1.0))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    got = tops.attention(tq, tk, tv, bq=bq, bk=bq).float().numpy()
    _close(got, jops.attention(jq, jk, jv, bq=bq, bk=bq)
           .astype(jnp.float32), TOL[dtype])
    _close(got, jref.attention_ref(jq, jk, jv).astype(jnp.float32),
           TOL[dtype])


@pytest.mark.parametrize("D", [192, 256])
def test_wide_heads_prefill_caps_the_block(D):
    """The LM prefill caps bq at max_bq(D) = 64: a 2100-token prompt takes
    bq 64, padded to 2176, and the kernel's checks accept it; bq 128 at
    these widths is refused before any launch."""
    assert tattn.attention_block(2100, tfa.max_bq(D)) == 64
    assert tattn.attention_block(2100) == 128
    q = torch.zeros((1, 2, 2176, D), dtype=torch.bfloat16)
    tfa.check_kernel_operands(q, q, q, 64)
    with pytest.raises(ValueError, match="bq up to 64"):
        tfa.check_kernel_operands(q, q, q, 128)
    rng = np.random.default_rng(D)
    qn, kn, vn = (rng.normal(size=(1, 70, H, D)).astype(np.float32) * 0.3
                  for H in (2, 1, 1))
    want = jattn._chunked_causal(jnp.asarray(qn), jnp.asarray(kn),
                                 jnp.asarray(vn), chunk=32, window=0,
                                 softcap_val=0.0, scale=1.0 / np.sqrt(D))
    got = tattn.prefill_attention(*(torch.from_numpy(a)
                                    for a in (qn, kn, vn)))
    _close(got.numpy(), want, TOL["float32"])
