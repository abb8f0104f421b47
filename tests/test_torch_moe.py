"""The port's MoE family (``repro_torch/models/blocks.py``: the capacity
dispatch, ``moe_ffn``, the MoE layer; ``models/build.py``'s MoE pools and
parameter counts) against the JAX package on the CPU, at fp32, on inputs
made from numpy seeds.

* the dispatch on a skewed router that drops tokens: the same top-k picks,
  the same ``keep`` mask (capacity drops, token-major), the same output and
  switch loss;
* ``moe_ffn`` at n = 4096 (two chunks of 2048) with the reference's aux
  scaling, applied twice (ROADMAP Queue 3);
* one MoE layer (attention + MoE FFN with shared experts);
* smoke deepseek-moe-16b (2 shared experts) and dbrx-132b (none): the loss
  and every pool's gradient through ``params_from_jax``;
* the fixed-batch prefill and decode;
* the paged engine step: the port keeps the engine's dead rows (past a
  slot's ``n_new``) out of the dispatch, the reference routes them; the
  live rows agree where no dead row comes before a live one in the
  reference's token order (its recorded routing drops live tokens there,
  and the port drops the same ones); within the port the dead rows'
  tokens never reach the live rows;
* the registry and the exact and active parameter counts of the five
  configs this family and the dense ones add, at full size.

Tolerances: the same fp32 math in other orders of sums; the measured
errors are in ``TOL``'s comment.  Ties in the router (``torch.topk`` and
``lax.top_k`` may order them differently) are absent on seeded fp32 data;
each test asserts the picks agree before it compares outputs.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import init_state as jax_init_state  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.build import active_param_count as jax_active  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.models.build import exact_param_count as jax_exact  # noqa: E402
from repro.models.dims import attn_dims as jax_attn_dims  # noqa: E402
from repro.runtime import paged as JPG  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.mics import MiCSConfig, accumulate_grads  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.build import active_param_count, build_model  # noqa: E402
from repro_torch.models.build import exact_param_count  # noqa: E402
from repro_torch.models.dims import attn_dims  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402

# Port against JAX at fp32, as a fraction of the largest reference value
# (measured on the CPU with this file's inputs: dispatch 1.9e-7, moe_ffn
# 2.4e-7, layer 3.8e-7, loss 1.4e-7 relative, gradients 3.4e-6, prefill and
# decode logits 4.1e-7, engine logits 4.7e-7).
TOL = 1e-5
NEW_CONFIGS = ("granite-8b", "yi-9b", "qwen1.5-110b", "deepseek-moe-16b", "dbrx-132b")
CTX_T = L.Ctx(mode="train", compute_dtype=torch.float32)
CTX_J = JL.Ctx(mode="train", compute_dtype=jnp.float32)


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


def _cfg(arch: str):
    return smoke_variant(get_config(arch)), jax_smoke(jax_get_config(arch))


def _weights(cfg, seed: int) -> dict:
    """Random tensors of one MoE layer's tp = 1 layout (std 0.2; the norm
    scales near 0, as their zero init)."""
    rng = np.random.default_rng(seed)
    b = B.LayoutBuilder()
    B.moe_layer_layout(cfg, 1, b)
    return {s.name: (rng.standard_normal(s.shape) * (0.05 if s.name.endswith("scale") else 0.2)
                     ).astype(np.float32) for s in b.build().segments}


def _jax_routing(x2d, router_w, cfg):
    """The reference's routing, as ``repro/models/blocks.py:454-466``
    computes it: picks, positions in their experts and the keep mask."""
    n = x2d.shape[0]
    cap = int(np.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    cap = max(4, ((cap + 3) // 4) * 4)
    probs = jax.nn.softmax((x2d @ router_w).astype(jnp.float32), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = gate_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(flat_e.shape[0]), flat_e]
    return gate_idx, pos < cap


def _skewed_tokens(seed: int, n: int, d: int = 64) -> np.ndarray:
    """Tokens sharing a strong common direction, so the router sends most
    of them to the same experts and the capacity drops some."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + 3.0 * rng.standard_normal(d)).astype(np.float32)


def test_dispatch_drops_the_reference_tokens():
    cfg_t, cfg_j = _cfg("deepseek-moe-16b")
    w = _weights(cfg_t, 0)
    x = _skewed_tokens(1, 64)
    idx_j, keep_j = jax.jit(lambda x, r: _jax_routing(x, r, cfg_j))(x, w["router.w"])
    keep_j = np.asarray(keep_j)
    assert 0 < (~keep_j).sum() < keep_j.size      # the case drops tokens, not all
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    _, _, idx_t, _, keep_t, cap = B.moe_route(torch.from_numpy(x), t["router.w"], cfg_t)
    assert cap == B.moe_capacity(64, cfg_t) == 20
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert np.array_equal(keep_t.numpy(), keep_j)
    y_j, aux_j = jax.jit(lambda x, t: JB._moe_dispatch_tokens(x, t, cfg_j, CTX_J))(
        x, {k: w[k] for k in ("router.w", "moe.wg", "moe.wu", "moe.wd")})
    y_t, aux_t = B._moe_dispatch_tokens(torch.from_numpy(x), t, cfg_t, CTX_T)
    _close(y_t.numpy(), y_j, "dispatch")
    _close(aux_t.numpy(), aux_j, "aux")
    # a dropped assignment adds nothing: a token whose picks are all dropped
    # leaves the routed experts with a zero output
    dropped = ~keep_j.reshape(64, cfg_t.top_k).any(axis=1)
    assert not y_t.numpy()[dropped].any()


def test_moe_ffn_chunks_and_doubled_aux_scaling():
    """n = 4096 routes in two chunks of 2048 (``moe_chunk``), each with its
    own capacity; aux is the chunks' sum scaled by chunk / n twice, as the
    reference computes it."""
    cfg_t, cfg_j = _cfg("deepseek-moe-16b")
    w = _weights(cfg_t, 2)
    x = np.random.default_rng(3).standard_normal((2, 2048, 64)).astype(np.float32)
    assert B.moe_chunk(4096) == 2048 and B.moe_chunk(2048) == 1024 and B.moe_chunk(4) == 4
    y_j, aux_j = jax.jit(lambda x, t: JB.moe_ffn(t, x, cfg_j, CTX_J))(x, w)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    y_t, aux_t = B.moe_ffn(t, torch.from_numpy(x), cfg_t, CTX_T)
    _close(y_t.numpy(), y_j, "moe_ffn")
    _close(aux_t.numpy(), aux_j, "aux")
    x2d = torch.from_numpy(x).reshape(4096, 64)
    chunks = [B._moe_dispatch_tokens(x2d[c:c + 2048], t, cfg_t, CTX_T)[1] for c in (0, 2048)]
    assert torch.allclose(aux_t, (chunks[0] + chunks[1]) * 0.5 * 0.5, rtol=1e-6)


def test_moe_layer_apply_matches_jax():
    cfg_t, cfg_j = _cfg("deepseek-moe-16b")
    w = _weights(cfg_t, 4)
    x = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(np.float32)
    ad_j = jax_attn_dims(cfg_j.d_model, cfg_j.n_heads, cfg_j.n_kv_heads,
                         cfg_j.resolved_head_dim, 1)
    (y_j, aux_j), _ = jax.jit(lambda x, t: JB.moe_layer_apply(cfg_j, ad_j, t, x, CTX_J))(x, w)
    ad_t = attn_dims(cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.resolved_head_dim, 1)
    (y_t, aux_t), cache = B.moe_layer_apply(
        cfg_t, ad_t, {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x), CTX_T)
    assert cache is None
    _close(y_t.numpy(), y_j, "layer")
    _close(aux_t.numpy(), aux_j, "aux")


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(model_j, topo1, params_np, batch):
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.comm import CommEngine as JaxCommEngine
    from repro.core.mics import batch_pspecs, state_pspecs
    from repro.models import lm as JLM

    comm = JaxCommEngine.from_config(topo1, JaxMiCSConfig(gather_dtype=jnp.float32))

    def loss_and_grads(params, mb):
        (loss, m), g = jax.value_and_grad(
            lambda p: JLM.loss_fn(model_j, p, comm, CTX_J, mb), has_aux=True)(params)
        return m["loss"], m["aux"], g

    pspec = state_pspecs(model_j, topo1)["params"]
    fn = jax.jit(shard_map(loss_and_grads, mesh=topo1.mesh,
                           in_specs=(pspec, batch_pspecs(model_j, topo1, micro=False)),
                           out_specs=(P(), P(), pspec), check_vma=False))
    loss, aux, grads = fn({k: jnp.asarray(v) for k, v in params_np.items()},
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(aux), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_loss_and_grads_match_jax(topo1, arch):
    """One micro-step of ``accumulate_grads`` against ``jax.value_and_grad``
    of the reference's ``loss_fn`` (cross-entropy + router_aux_weight x
    aux, the aux summed over the layers): the cross-entropy and the aux
    metrics, and every pool's gradient of their sum."""
    cfg_t, cfg_j = _cfg(arch)
    assert (cfg_t.n_experts, cfg_t.top_k, cfg_t.d_ff) == (8, 2, 32)
    model_j = jax_build_model(cfg_j, tp=1)
    params_np = {k: np.asarray(v) for k, v in jax_init_state(model_j, topo1, seed=5)[
        "params"].items()}
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg_j.vocab, (2, 32)).astype(np.int32),
             "targets": rng.integers(0, cfg_j.vocab, (2, 32)).astype(np.int32),
             "mask": (rng.uniform(size=(2, 32)) < 0.9).astype(np.float32)}
    want_ce, want_aux, want = _jax_loss_and_grads(model_j, topo1, params_np, batch)
    model = build_model(cfg_t, tp=1)
    params = params_from_jax(model, params_np, device="cpu")
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32))
    grads, loss, aux = accumulate_grads(
        model, comm, CTX_T, params, {k: torch.as_tensor(v)[None] for k, v in batch.items()})
    _close(loss.item(), want_ce, "cross-entropy")
    _close(aux.item(), want_aux, "aux")
    assert want_aux > 0
    for name, w in want.items():
        _close(grads[name].numpy(), w, f"grad {name}")


# ---------------------------------------------------------------------------
# serving: the fixed batch and the paged engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(topo1):
    cfg_t, cfg_j = _cfg("deepseek-moe-16b")
    model_j = jax_build_model(cfg_j, tp=1)
    params_j = jax_init_state(model_j, topo1, seed=8)["params"]
    model = build_model(cfg_t, tp=1)
    params = params_from_jax(model, {k: np.asarray(v) for k, v in params_j.items()},
                             device="cpu")
    return model_j, params_j, model, params


def test_fixed_batch_prefill_and_decode_match_jax(served, topo1):
    """Prefill of 2 x 16 then 3 greedy steps (n = 2 a step: the decode
    capacity's floor of 4 slots an expert): logits and tokens."""
    model_j, params_j, model, params = served
    tokens = np.random.default_rng(9).integers(1, 256, (2, 16)).astype(np.int32)
    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32), 24)
    pt, dt = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32), 24,
                               device="cpu")
    lj, cj = pj(params_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = pt(params, {"tokens": torch.from_numpy(tokens).long()})
    _close(lt.numpy(), lj, "prefill")
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(3):
        lj, tok_j, cj = dj(params_j, cj, tok_j, jnp.int32(16 + i))
        lt, tok_t, ct = dt(params, ct, tok_t, 16 + i)
        _close(lt.numpy(), lj, f"decode {i}")
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))


ENGINE_BS, ENGINE_MB = 4, 6
# (chunk width, n_new a slot) a tick: slots 0-2 stream 18-token prompts in
# two chunks of 9 while slot 3 takes a 5-token prompt and then decodes, so
# every dead row comes after every live one in the token-major order; then
# two decode ticks at width 1 (no dead rows)
ENGINE_TICKS = ((9, (9, 9, 9, 5)), (9, (9, 9, 9, 1)), (1, (1, 1, 1, 1)), (1, (1, 1, 1, 1)))


def _engine_inputs():
    tables = np.arange(1, 4 * ENGINE_MB + 1, dtype=np.int32).reshape(4, ENGINE_MB)
    prompts = np.random.default_rng(10).integers(1, 256, (4, 18)).astype(np.int32)
    return tables, prompts


def test_engine_live_rows_match_jax(served, topo1, monkeypatch):
    """The paged step (fp32 pools, blocks of 4) against the reference's on
    the same weights and tokens, tick by tick: logits and sampled tokens.
    The reference routes the engine's dead rows (their values are its own,
    not the port's), the port keeps them out of the dispatch; both take the
    capacity of all n rows.  Every dead row here comes after every live row
    in the token-major order, so no dead row takes a slot before a live one
    in the reference either, and the live rows' routing is the same in both
    (asserted from the reference's recorded routing of every layer, which
    drops live tokens at the chunked-prefill ticks: the port drops the same
    ones)."""
    model_j, params_j, model, params = served
    cfg_j = model_j.cfg
    records = []
    real = JB._moe_dispatch_tokens

    def recording(x2d, t, cfg, ctx):
        _, keep = _jax_routing(x2d, t["router.w"], cfg)
        jax.debug.callback(lambda k: records.append(np.asarray(k)), keep)
        return real(x2d, t, cfg, ctx)

    monkeypatch.setattr(JB, "_moe_dispatch_tokens", recording)
    tables, prompts = _engine_inputs()
    mcfg_j = JaxMiCSConfig(gather_dtype=jnp.float32, kv_dtype="fp32", kv_block_size=ENGINE_BS)
    mcfg_t = MiCSConfig(gather_dtype=torch.float32)
    steps_j, steps_t = {}, {}
    for w in (9, 1):
        steps_j[w] = JPG.build_paged_step(model_j, topo1, mcfg_j, max_blocks=ENGINE_MB,
                                          block_size=ENGINE_BS, chunk=w, kv_dtype="fp32")
        steps_t[w] = PG.build_paged_step(model, MiCSTopology(), mcfg_t, max_blocks=ENGINE_MB,
                                         block_size=ENGINE_BS, chunk=w, kv_dtype="fp32",
                                         device="cpu")
    pool_j, _ = JPG.init_paged_caches(model_j, topo1, 4 * ENGINE_MB + 1, ENGINE_BS, "fp32")
    pool_t = PG.init_paged_caches(model, MiCSTopology(), 4 * ENGINE_MB + 1, ENGINE_BS, "fp32",
                                  device="cpu")
    # the dead rows hold seeded tokens: the reference routes them
    fill = np.random.default_rng(13).integers(1, 256, (len(ENGINE_TICKS), 4, 9))
    pos, last = np.zeros(4, np.int64), np.zeros(4, np.int64)
    seeds, temps = np.arange(4, dtype=np.int32), np.zeros(4, np.float32)
    live_drops = 0
    for tick, (w, n_new) in enumerate(ENGINE_TICKS):
        n_new = np.asarray(n_new, np.int32)
        toks = fill[tick, :, :w].astype(np.int32)
        for b in range(4):
            if pos[b] < (18 if b < 3 else 5):
                toks[b, :n_new[b]] = prompts[b, pos[b]:pos[b] + n_new[b]]
            else:
                toks[b, 0] = last[b]
        live = np.repeat((np.arange(w)[None, :] < n_new[:, None]).reshape(-1), cfg_j.top_k)
        first_dead = len(live) if live.all() else int(np.argmin(live))
        assert not live[first_dead:].any()      # every dead row after every live one
        records.clear()
        t_j, lg_j, pool_j = steps_j[w](params_j, pool_j, jnp.asarray(toks), jnp.asarray(pos),
                                       jnp.asarray(n_new), jnp.asarray(tables),
                                       jnp.asarray(seeds), jnp.asarray(temps))
        jax.effects_barrier()
        assert len(records) == cfg_j.n_layers
        live_drops += sum(int((~r[live]).sum()) for r in records)
        t_t, lg_t, pool_t = steps_t[w](params, pool_t, toks, pos, n_new, tables, seeds, temps)
        _close(lg_t.numpy(), lg_j, f"tick {tick}")
        assert np.array_equal(t_t.numpy(), np.asarray(t_j))
        pos, last = pos + n_new, np.asarray(t_j)
    assert live_drops > 0


def test_engine_dead_rows_do_not_reach_the_live_rows(served):
    """Whatever tokens sit in the dead rows, the live rows' logits are the
    same bits: the dead rows take no expert slot (the capacity is n's)."""
    _, _, model, params = served
    tables, prompts = _engine_inputs()
    step = PG.build_paged_step(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32),
                               max_blocks=ENGINE_MB, block_size=ENGINE_BS, chunk=9,
                               kv_dtype="fp32", device="cpu")
    n_new = np.asarray([3, 1, 0, 2], np.int32)
    outs = []
    for fill in (0, 7, 200):
        toks = np.where(np.arange(9)[None, :] < n_new[:, None], prompts[:, :9], fill)
        pool = PG.init_paged_caches(model, MiCSTopology(), 4 * ENGINE_MB + 1, ENGINE_BS, "fp32",
                                    device="cpu")
        _, lg, _ = step(params, pool, toks, np.zeros(4), n_new, tables, np.zeros(4),
                        np.zeros(4, np.float32))
        outs.append(lg)
    live = torch.as_tensor(n_new > 0)
    assert torch.equal(outs[0][live], outs[1][live]) and torch.equal(outs[0][live],
                                                                     outs[2][live])


def test_dead_rows_take_no_expert_slot():
    """``moe_route`` with a live mask: a dead row counts in no expert's
    slots and is never kept, and the capacity is that of all n rows; the
    live rows' slots are the ones they get with the dead rows removed."""
    cfg, _ = _cfg("deepseek-moe-16b")
    w = torch.from_numpy(_weights(cfg, 11)["router.w"])
    x = torch.from_numpy(_skewed_tokens(12, 36))
    live = torch.arange(36) % 9 < torch.tensor([3, 7, 5, 9]).repeat_interleave(9)
    _, _, idx, pos, keep, cap = B.moe_route(x, w, cfg, live)
    assert cap == B.moe_capacity(36, cfg)
    rep = live.repeat_interleave(cfg.top_k)
    assert not keep[~rep].any()
    _, _, idx_l, pos_l, _, _ = B.moe_route(x[live], w, cfg)
    assert torch.equal(idx[live], idx_l) and torch.equal(pos[rep], pos_l)


# ---------------------------------------------------------------------------
# the registry and the parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_configs_and_counts_match_the_reference(arch):
    """Each config is the reference's, field for field; the port builds it
    and its exact and active parameter counts are the reference's (expert
    segments count top_k / n_experts of their size as active)."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert arch in REGISTRY
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert exact_param_count(cfg) == jax_exact(ref)
    assert active_param_count(cfg) == jax_active(ref)
    assert (active_param_count(cfg) < exact_param_count(cfg)) == (cfg.family == "moe")
    smoke = smoke_variant(cfg)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(jax_smoke(ref))
    assert exact_param_count(smoke) == jax_exact(jax_smoke(ref))
