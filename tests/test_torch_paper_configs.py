"""The paper's own workloads (``configs/bert_paper.py``: the MiCS paper's
Table 1, bert-10b ... gpt2-20b: causal dense decoders with LayerNorm, the
biased GeLU MLP and no positional signal) and the flash wrapper at a head
dim outside the kernels' (bert-50b's 8192 // 40 = 204), against the JAX
package on the CPU:

* every registered config: the reference's fields, its ``exact_param_count``
  and ``active_param_count``; whisper and the six paper configs built at tp
  1, 2 and 4 with the reference's segments;
* the padded attention (dh 204 zero-padded to 256 at the true head dim's
  scale, then cut back) equal to the unpadded plain attention, forward and
  backward, fp32 and bf16, and to the reference's ``layers.attention``;
* a smoke paper config at an odd head dim (d 64 over 3 heads: dh 21, padded
  to 32, as bert-50b's d // h): the loss and every pool's gradient, the
  prefill and greedy decode, against the JAX package;
* smoke bert-10b and the odd head dim in the paged engine (the pool at the
  padded width): a step against the reference's, and paged == contiguous
  bit for bit within the port.

Norm scales, norm biases and linear biases are random
(``torch_dist_cases.numpy_params``): zero at init, a swapped or dropped
one would pass there.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.build import active_param_count as jax_active  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.models.build import exact_param_count as jax_exact  # noqa: E402
from repro.runtime import paged as JPG  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.bert_paper import PAPER_CONFIGS  # noqa: E402
from repro_torch.convert import params_from_jax, tp_params_from_full  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.mics import MiCSConfig, accumulate_grads  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import active_param_count, build_model  # noqa: E402
from repro_torch.models.build import exact_param_count  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402
import torch_dist_cases as K  # noqa: E402

# Port against JAX at fp32, as a fraction of the largest reference value
# (measured on the CPU with this file's inputs: the loss 1.6e-7, gradients
# <= 7.4e-7, prefill and decode logits <= 6.4e-7, the paged step's logits
# <= 5.6e-7; the padded attention against the reference's at dh 204
# 1.9e-7).
TOL = 1e-5
# The padded attention against the unpadded plain version, as a fraction
# of the largest value: the zero columns add exact zeros, so only the order
# of the CPU's sums over 256 columns instead of 204 may differ (measured:
# the forward bitwise, fp32 dq / dk <= 1.3e-7, dv bitwise; bf16 bitwise).
# bf16 allows one value rounded to its neighbour (2^-8).
PAD_TOL = {torch.float32: 1e-6, torch.bfloat16: 4e-3}
PAPER = sorted(PAPER_CONFIGS)
BUILT = ["whisper-large-v3", *PAPER]
T = 16
CAP = 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max |err| {err} > {tol} x {scale}"


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_config_and_count_is_the_reference(name):
    """The port registers every config the reference does (the ten assigned
    and the paper's six), field for field, with the same exact and active
    parameter counts."""
    cfg, cfg_j = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    assert exact_param_count(cfg) == jax_exact(cfg_j)
    assert active_param_count(cfg) == jax_active(cfg_j)


def test_registry_is_the_reference():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    assert {c.name: (c.family, c.norm, c.mlp, c.use_rope) for c in PAPER_CONFIGS.values()} \
        == {n: ("dense", "ln", "gelu", False) for n in PAPER}
    assert get_config("bert-50b").resolved_head_dim == 204


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", BUILT)
def test_builds_the_reference_layout(name, tp):
    """``build_model`` at full size: the reference's pools, stacks and
    segments (names, shapes, offsets, model gathers)."""
    model, model_j = build_model(get_config(name), tp), jax_build_model(jax_get_config(name), tp)
    assert model.global_flat_shapes() == model_j.global_flat_shapes()
    for pool, pool_j in zip(model.all_pools(), model_j.all_pools(), strict=True):
        assert [(s.name, s.shape, s.offset, s.model_gather) for s in pool.layout.segments] == \
            [(s.name, s.shape, s.offset, s.model_gather) for s in pool_j.layout.segments]


def test_padded_head_dims():
    assert [FA.padded_head_dim(d) for d in (16, 17, 64, 100, 128, 204, 256)] == \
        [16, 32, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="pads to none"):
        FA.padded_head_dim(257)
    q = torch.zeros(1, 2, 1, 1, 300)
    with pytest.raises(ValueError, match="pads to none"):
        L.attention(q, q[:, :, 0], q[:, :, 0])
    with pytest.raises(ValueError):  # the kernels' wrapper takes no other head dim
        FA.flash_attention(*(t[..., :204] for t in (q, q[:, :, 0], q[:, :, 0])))


def _qkv(dt, b=2, tq=9, tk=9, hkv=2, g=2, dh=204, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, hkv, g, dh, generator=gen).to(dt)
    k, v = (torch.randn(b, tk, hkv, dh, generator=gen).to(dt) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_attention_equals_unpadded(dt, causal):
    """``layers.attention`` at dh 204 (padded to 256, the scale
    1/sqrt(204), cut back), without and with a gradient (``FlashAttentionFn``
    under autograd's pad and cut), against ``attention_plain`` and its
    backward at 204 on the same inputs; the scale of the padded width
    (1/sqrt(256)) gives another function; fp32 also against the
    reference's ``layers.attention``."""
    q, k, v = _qkv(dt, tk=9 if causal else 13)
    kw = dict(causal=causal, window=0, q_offset=0, kv_valid_len=None)
    tol = PAD_TOL[dt]
    want, lse = FA.attention_plain_lse(q, k, v, **kw)
    _close(L.attention(q, k, v, **kw).float(), want.float(), "forward", tol)
    wrong = FA.attention_plain(*(torch.nn.functional.pad(t, (0, 52)) for t in (q, k, v)), **kw)
    assert (wrong[..., :204].float() - want.float()).abs().max() > 10 * tol
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    out = L.attention(qr, kr, vr, **kw)
    assert out.shape == q.shape and out.grad_fn is not None
    _close(out.detach().float(), want.float(), "FlashAttentionFn forward", tol)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dt)
    out.backward(do)
    refs = FA.flash_attention_bwd_plain(q, k, v, want, lse, do, **kw)
    for name, got, ref in zip("qkv", (qr.grad, kr.grad, vr.grad), refs):
        assert got.shape == ref.shape
        _close(got.float(), ref.float(), f"d{name}", tol)
    if dt == torch.float32:
        jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
        _close(out.detach(), JL.attention(jq, jk, jv, causal=causal), "against JAX")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_padded_attention_with_row_lengths(dt):
    """At dh 204 per-row valid lengths (the engine's contiguous step: the
    ``paged`` route over a pool of one block a request) take the same pad
    and the scale of 204: equal to the unpadded plain attention, a dead row
    (length 0) exactly zero."""
    q, k, v = _qkv(dt, tq=3, tk=11)
    kvl = torch.tensor([11, 0])
    want = FA.attention_plain(q, k, v, causal=False, kv_valid_len=kvl.clamp_min(1))
    got = L.attention(q, k, v, causal=False, kv_valid_len=kvl)
    assert got.shape == q.shape and not got[1].any()
    _close(got[0].float(), want[0].float(), "row lengths", PAD_TOL[dt])


def _odd_cfg():
    """A smoke paper config at an odd head dim: d 64 over 3 heads, head dim
    64 // 3 = 21 (the d // h of bert-50b's 8192 / 40), padded to 32."""
    kw = dict(n_heads=3, n_kv_heads=3, head_dim=0)
    return (dataclasses.replace(smoke_variant(get_config("bert-50b")), **kw),
            dataclasses.replace(jax_smoke(jax_get_config("bert-50b")), **kw))


@pytest.fixture(scope="module")
def odd():
    cfg_t, cfg_j = _odd_cfg()
    assert cfg_t.resolved_head_dim == 21
    model, model_j = build_model(cfg_t, tp=1), jax_build_model(cfg_j, tp=1)
    params_np = K.numpy_params(model, "paper:odd")
    rng = np.random.default_rng(3)
    shape = (1, 2, T)
    batch = {"tokens": rng.integers(0, cfg_t.vocab, shape).astype(np.int32),
             "targets": rng.integers(0, cfg_t.vocab, shape).astype(np.int32),
             "mask": (rng.uniform(size=shape) < 0.9).astype(np.float32)}
    return model, model_j, params_np, batch


def test_odd_head_dim_loss_and_grads_match_jax(odd, topo1):
    """One micro-step's loss and every pool's gradient through the padded
    route (``FlashAttentionFn`` at dh 21 -> 32), against ``jax.grad`` of
    the reference's loss."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.comm import CommEngine as JaxCommEngine
    from repro.core.mics import batch_pspecs, state_pspecs
    from repro.models import lm as JLM

    model, model_j, params_np, batch = odd
    comm_j = JaxCommEngine.from_config(topo1, JaxMiCSConfig(gather_dtype=jnp.float32))
    ctx_j = JL.Ctx(mode="train", compute_dtype=jnp.float32)

    def loss_and_grads(params, mb):
        (loss, _), g = jax.value_and_grad(
            lambda p: JLM.loss_fn(model_j, p, comm_j, ctx_j, mb), has_aux=True)(params)
        return loss, g

    pspec = state_pspecs(model_j, topo1)["params"]
    fn = jax.jit(shard_map(loss_and_grads, mesh=topo1.mesh,
                           in_specs=(pspec, batch_pspecs(model_j, topo1, micro=False)),
                           out_specs=(P(), pspec), check_vma=False))
    want_loss, want = fn({k: jnp.asarray(v) for k, v in params_np.items()},
                         {k: jnp.asarray(v[0]) for k, v in batch.items()})
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32))
    grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train",
                                                         compute_dtype=torch.float32),
                                      params_from_jax(model, params_np, device="cpu"),
                                      {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss.item(), float(want_loss), "loss")
    for name, w in want.items():
        assert np.abs(np.asarray(w)).max() > 0, name
        _close(grads[name].numpy(), np.asarray(w), f"grad {name}")


def test_odd_head_dim_serve_matches_jax(odd, topo1):
    """The fixed batch through the padded route: the prefill (no positions:
    the paper configs have no rotary and no learned table) and 3 greedy
    decode steps; logits within TOL, tokens equal."""
    model, model_j, params_np, _ = odd
    tokens = np.random.default_rng(4).integers(1, 256, (2, T)).astype(np.int32)
    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32), CAP)
    pt, dt = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32),
                               CAP, device="cpu")
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_jax(model, params_np, device="cpu")
    lj, cj = pj(params_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = pt(params, {"tokens": torch.from_numpy(tokens).long()})
    _close(lt.numpy(), lj, "prefill")
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(3):
        lj, tok_j, cj = dj(params_j, cj, tok_j, jnp.int32(T + i))
        lt, tok_t, ct = dt(params, ct, tok_t, T + i)
        _close(lt.numpy(), lj, f"decode {i}")
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))


PLENS = [3, 7, 5, 9]
STEPS = 3
BS = 4


@pytest.fixture(scope="module")
def bert():
    cfg_t = smoke_variant(get_config("bert-10b"))
    model = build_model(cfg_t, tp=1)
    model_j = jax_build_model(jax_smoke(jax_get_config("bert-10b")), tp=1)
    params_np = K.numpy_params(model, "paper:bert-10b")
    prompts = np.random.default_rng(5).integers(1, cfg_t.vocab, (len(PLENS), max(PLENS)))
    return model, model_j, params_np, prompts


def _tables(extra: int = STEPS):
    alloc = PG.PagedKVAllocator(sum(PG.blocks_for(n + extra, BS) for n in PLENS) + 1, BS)
    mb = -(-CAP // BS)
    tables = np.zeros((len(PLENS), mb), np.int32)
    for b, n in enumerate(PLENS):
        blocks = alloc.alloc(PG.blocks_for(n + extra, BS))
        tables[b, :len(blocks)] = blocks
    return tables, alloc.n_blocks


def _odd_prompts(model):
    return np.random.default_rng(6).integers(1, model.cfg.vocab, (len(PLENS), max(PLENS)))


def test_paged_step_matches_jax(bert, topo1):
    """smoke bert-10b in the engine: the prompts in one chunk, then decode
    steps at the same width, fp32 pools: logits within TOL and tokens
    equal to the reference's paged step fed the same tokens."""
    _paged_step_matches_jax(*bert, topo1)


def test_odd_head_dim_paged_step_matches_jax(odd, topo1):
    """The engine at an odd head dim (dh 21): its pools stored at the padded
    width (32) and read through the padded ``paged`` route at the scale of
    21, against the reference's paged step over pools of width 21."""
    model, model_j, params_np, _ = odd
    assert PG.init_paged_caches(model, MiCSTopology(), 2, BS, "fp32",
                                device="cpu")["layers"]["k"].shape[-1] == 32
    _paged_step_matches_jax(model, model_j, params_np, _odd_prompts(model), topo1)


def _paged_step_matches_jax(model, model_j, params_np, prompts, topo1):
    tables, nb = _tables()
    b, width = len(PLENS), max(PLENS)
    seeds, temps = np.arange(b, dtype=np.int32), np.zeros(b, np.float32)
    jstep = JPG.build_paged_step(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32,
                                                                kv_dtype="fp32",
                                                                kv_block_size=BS),
                                 max_blocks=tables.shape[1], block_size=BS, chunk=width,
                                 kv_dtype="fp32")
    tstep = PG.build_paged_step(model, MiCSTopology(), MiCSConfig(
        gather_dtype=torch.float32, kv_dtype="fp32", kv_block_size=BS),
        max_blocks=tables.shape[1], block_size=BS, chunk=width, device="cpu")
    jpool, _ = JPG.init_paged_caches(model_j, topo1, nb, BS, "fp32")
    tpool = PG.init_paged_caches(model, MiCSTopology(), nb, BS, "fp32", device="cpu")
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_jax(model, params_np, device="cpu")
    toks = np.zeros((b, width), np.int32)
    for i, n in enumerate(PLENS):
        toks[i, :n] = prompts[i, :n]
    pos, n_new = np.zeros(b, np.int32), np.asarray(PLENS, np.int32)
    for s in range(1 + STEPS):
        tj, lj, jpool = jstep(params_j, jpool, jnp.asarray(toks), jnp.asarray(pos),
                              jnp.asarray(n_new), jnp.asarray(tables), jnp.asarray(seeds),
                              jnp.asarray(temps))
        tt, lt, tpool = tstep(params, tpool, toks, pos, n_new, tables, seeds, temps)
        _close(lt.float().numpy(), np.asarray(lj), f"step {s}")
        assert np.array_equal(tt.numpy(), np.asarray(tj)), s
        pos, n_new = pos + n_new, np.ones(b, np.int32)
        toks = np.zeros((b, width), np.int32)
        toks[:, 0] = np.asarray(tj)


def test_paged_equals_contiguous_bitwise(bert):
    """smoke bert-10b: the paged step over a pool filled from contiguous
    prefill caches (``pages_from_contiguous``) against the contiguous
    vector-position step, greedy and sampled rows: tokens and logits bit
    for bit."""
    model, _, params_np, prompts = bert
    _paged_equals_contiguous(model, params_np, prompts)


def test_odd_head_dim_paged_equals_contiguous_bitwise(odd):
    """As above at dh 21: ``pages_from_contiguous`` pads the prefill caches
    into the pool's width of 32, and both steps take the same padded route."""
    model, _, params_np, _ = odd
    _paged_equals_contiguous(model, params_np, _odd_prompts(model))


def _paged_equals_contiguous(model, params_np, prompts):
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype="bf16", kv_block_size=BS)
    params = params_from_jax(model, params_np, device="cpu")
    prefill_fn, _ = build_serve_steps(model, MiCSTopology(),
                                      MiCSConfig(gather_dtype=torch.float32), CAP, device="cpu")
    b = len(PLENS)
    caches = lm.init_caches(model, b, CAP, dtype=torch.bfloat16, device="cpu")
    tok0 = np.zeros(b, np.int64)
    for i, n in enumerate(PLENS):
        logits, c = prefill_fn(params, {"tokens": torch.as_tensor(prompts[i:i + 1, :n])})
        for name in ("k", "v"):
            caches["layers"][name][:, i] = c["layers"][name][:, 0].to(torch.bfloat16)
        tok0[i] = int(torch.argmax(logits[0, -1, :model.cfg.vocab]))
    tables, nb = _tables()
    pool = PG.init_paged_caches(model, MiCSTopology(), nb, BS, "bf16", device="cpu")
    PG.pages_from_contiguous(model, MiCSTopology(), caches, pool, tables, PLENS, block_size=BS,
                             kv_dtype="bf16")
    paged = PG.build_paged_step(model, MiCSTopology(), mcfg, max_blocks=tables.shape[1],
                                block_size=BS, device="cpu")
    contig = PG.build_contiguous_step(model, MiCSTopology(), mcfg, CAP, device="cpu")
    seeds = np.arange(b, dtype=np.int64) * 11 + 1
    temps = np.array([0.0, 0.8, 0.0, 1.2], np.float32)
    tp_, tc = tok0.copy(), tok0.copy()
    pos = np.asarray(PLENS)
    for s in range(STEPS):
        t1, l1, pool = paged(params, pool, tp_[:, None], pos + s, np.ones(b), tables, seeds,
                             temps)
        t2, l2, caches = contig(params, caches, tc[:, None], pos + s, seeds, temps)
        assert torch.equal(t1, t2) and torch.equal(l1, l2), s
        tp_, tc = t1.numpy(), t2.numpy()


def test_tp_cut_keeps_the_biases():
    """``tp_params_from_full`` cuts every new segment of the LayerNorm +
    GeLU layers and whisper's embeddings along its sharded dim: the norm
    biases and ``b2`` / ``bo`` by their model gather, ``b1`` / ``bq`` by
    column, ``emb.pos`` / ``emb.audio_pos`` by ``d``; the shards put back
    together are the whole."""
    for arch in ("whisper-large-v3", "bert-10b"):
        cfg = smoke_variant(get_config(arch))
        m1, m2 = build_model(cfg, 1), build_model(cfg, 2)
        full = K.numpy_params(m1, "paper:cut")
        cut = tp_params_from_full(m2, m1, full)
        for name, pool1 in full.items():
            l1, l2 = m1.pool(name).layout, m2.pool(name).layout
            for s1, s2 in zip(l1.segments, l2.segments, strict=True):
                whole = pool1[:, 0, s1.offset:s1.end].reshape(-1, *s1.shape)
                parts = [cut[name][:, j, s2.offset:s2.end].reshape(-1, *s2.shape)
                         for j in range(2)]
                if s1.shape == s2.shape:
                    assert all(np.array_equal(p, whole) for p in parts), s1.name
                else:
                    dim = 1 + [a != b_ for a, b_ in zip(s1.shape, s2.shape)].index(True)
                    assert np.array_equal(np.concatenate(parts, axis=dim), whole), s1.name
    assert math.isclose(1.0 / math.sqrt(204), FA.kernel._scale(204, None))
