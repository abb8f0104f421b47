"""The port's paged KV engine (``repro_torch/runtime/paged.py``), the
``paged`` route's plain version and the seeded sampler on the CPU.

* ``build_paged_step`` against the JAX package's on the same weights
  (``convert.params_from_jax``), smoke llama3.2-1b on one CPU device, fp32
  gather: four ragged prompts (3, 7, 5, 9 tokens: 7 and 9 straddle both
  block sizes) streamed in one chunk, then decode steps fed JAX's tokens;
  fp32, bf16 and int8 KV at block sizes 4 and 8;
* within the port, paged == contiguous bit for bit (fp32 and bf16 KV, the
  reference's ``serve_harness.py`` ``paged_bitwise`` cells) and chunk
  placement bitwise at a fixed width (``chunked_prefill``);
* ``paged_attention_plain`` against ``attention_plain`` on a view gathered
  by hand, and against the reference's ``layers.attention`` with per-row
  valid lengths;
* the sampler's properties (``lm.sample_tokens``): temperature 0 is
  ``greedy_sample``; a draw is a function of (seed, position); other seeds
  decorrelate; the law softmax(logits / T) (chi-square); top-k support;
* on the card (``gpu``): the ``paged`` route against its plain version.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import init_state  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.runtime import paged as JPG  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.mics import MiCSConfig  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402

B = 4
PLENS = [3, 7, 5, 9]
STEPS = 4
CAP = 16
TOPO = MiCSTopology()
KV_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
MIXED_TEMPS = np.array([0.0, 0.7, 0.0, 0.9], np.float32)
SEEDS = np.arange(B, dtype=np.int32) * 101
# Port against JAX, fp32 gather: the logit rows differ by sums taken in
# other orders (measured on the CPU with this file's schedule: at most
# 4.0e-6 at |logit| <= 3.8, for every KV dtype and block size); 1e-4 leaves
# room for other BLAS builds.
LOGIT_ATOL = 1e-4
# The pools after the run: fp32 values within 1e-5 (measured 2.7e-6); a
# bf16 page may round an fp32 value ~1e-6 apart to the neighbouring bf16
# value, so within one ulp (2^-8 relative; measured equal).
POOL_ATOL = {"fp32": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(topo1):
    cfg_j = jax_smoke(jax_get_config("llama3.2-1b"))
    model_j = jax_build_model(cfg_j, tp=1)
    params_j = init_state(model_j, topo1, seed=7)["params"]
    params_np = {k: np.asarray(v) for k, v in params_j.items()}
    model_t = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    prompts = np.random.default_rng(0).integers(1, cfg_j.vocab, (B, max(PLENS)))
    return dict(model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_from_jax(model_t, params_np, device="cpu"), prompts=prompts,
                cache={})


def _tables(bs: int, extra: int = STEPS):
    """Each request's blocks from one allocator, lowest first, as the
    batcher hands them out; the rest of each row the garbage block 0."""
    alloc = PG.PagedKVAllocator(sum(PG.blocks_for(n + extra, bs) for n in PLENS) + 1, bs)
    mb = -(-(max(PLENS) + extra) // bs)
    tables = np.zeros((B, mb), np.int32)
    for b, n in enumerate(PLENS):
        blocks = alloc.alloc(PG.blocks_for(n + extra, bs))
        tables[b, :len(blocks)] = blocks
    return tables, alloc.n_blocks


def _chunk_tokens(prompts, width):
    toks = np.zeros((B, width), np.int32)
    for b, n in enumerate(PLENS):
        toks[b, :n] = prompts[b, :n]
    return toks


def _run_jax(s, topo1, kv, bs):
    """JAX: the prompts in one chunk of 9, then STEPS decode steps at the
    same width (n_new 1), each fed the token JAX sampled.  Returns the
    logit rows, the tokens and the final pools (numpy)."""
    key = (kv, bs)
    if key in s["cache"]:
        return s["cache"][key]
    tables, nb = _tables(bs)
    mcfg = JaxMiCSConfig(gather_dtype=jnp.float32, kv_dtype=kv, kv_block_size=bs)
    width = max(PLENS)
    step = JPG.build_paged_step(s["model_j"], topo1, mcfg, max_blocks=tables.shape[1],
                                block_size=bs, chunk=width, kv_dtype=kv)
    pool, _ = JPG.init_paged_caches(s["model_j"], topo1, nb, bs, kv)
    seeds, temps = jnp.asarray(SEEDS), jnp.zeros(B, jnp.float32)
    toks, pos, n_new = _chunk_tokens(s["prompts"], width), np.zeros(B, np.int32), PLENS
    out = {"logits": [], "tokens": []}
    for _ in range(1 + STEPS):
        t, lg, pool = step(s["params_j"], pool, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(np.asarray(n_new, np.int32)), jnp.asarray(tables),
                           seeds, temps)
        out["logits"].append(np.asarray(lg))
        out["tokens"].append(np.asarray(t))
        pos = pos + np.asarray(n_new, np.int32)
        n_new = np.ones(B, np.int32)
        toks = np.zeros((B, width), np.int32)
        toks[:, 0] = np.asarray(t)
    out["pool"] = jax.tree.map(np.asarray, pool)
    out["tables"], out["nb"] = tables, nb
    s["cache"][key] = out
    return out


def _run_torch(s, kv, bs, feed):
    """The port on the same schedule, each decode step fed ``feed``'s
    tokens (JAX's); returns what ``_run_jax`` returns."""
    tables, nb = _tables(bs)
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype=kv, kv_block_size=bs)
    width = max(PLENS)
    step = PG.build_paged_step(s["model_t"], TOPO, mcfg, max_blocks=tables.shape[1],
                               block_size=bs, chunk=width, device="cpu")
    pool = PG.init_paged_caches(s["model_t"], TOPO, nb, bs, kv, device="cpu")
    toks, pos, n_new = _chunk_tokens(s["prompts"], width), np.zeros(B, np.int32), PLENS
    out = {"logits": [], "tokens": []}
    for i in range(1 + STEPS):
        t, lg, pool = step(s["params_t"], pool, toks, pos, np.asarray(n_new, np.int32), tables,
                           SEEDS, np.zeros(B, np.float32))
        out["logits"].append(lg.float().numpy())
        out["tokens"].append(t.numpy())
        pos = pos + np.asarray(n_new, np.int32)
        n_new = np.ones(B, np.int32)
        toks = np.zeros((B, width), np.int32)
        toks[:, 0] = feed[i]
    out["pool"] = pool
    return out


def _deq(pool):
    """A pool's k / v as fp32 numpy (int8 pages dequantized)."""
    if "ks" not in pool:
        return {n: _f32(pool[n]) for n in ("k", "v")}
    out = {}
    for n in ("k", "v"):
        q = torch.as_tensor(np.array(pool[n]))
        sc = torch.as_tensor(np.array(pool[n + "s"]))
        out[n] = Q.dequantize_flat(q, sc, torch.float32).numpy()
    return out


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_step_matches_jax(setup, topo1, kv, bs):
    want = _run_jax(setup, topo1, kv, bs)
    got = _run_torch(setup, kv, bs, want["tokens"])
    for i in range(1 + STEPS):
        np.testing.assert_allclose(got["logits"][i], want["logits"][i], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i], err_msg=f"step {i}")
    # the written positions of every request (block 0 stays zeros in both)
    g, w = got["pool"]["layers"], want["pool"]["layers"]
    if kv == "int8":
        # Each package quantized its own fp32 rows (~1e-6 apart; the
        # reference's jitted quantizer also multiplies by fl(1/127), ROADMAP
        # Queue 3), so the pages are held to the quantizer's bound, not
        # bitwise: every value within absmax / 254 of the row it quantized.
        # The first layer's rows depend on the fed tokens alone, so there
        # that row is the fp32 run's; deeper, each side is within the bound
        # of its own row, and the two within twice the bound.
        ref = _deq(_run_jax(setup, topo1, "fp32", bs)["pool"]["layers"])
        dp, dj = _deq(g), _deq(w)
        for n in ("k", "v"):
            absmax = np.abs(ref[n][0]).max(-1, keepdims=True)   # dh 16: one block a row
            for deq in (dp, dj):
                assert (np.abs(deq[n][0] - ref[n][0]) <= absmax / 254 + 1e-6).all(), n
            absmax = np.abs(dj[n]).max(-1, keepdims=True)
            assert (np.abs(dp[n] - dj[n]) <= absmax / 127 + 1e-5).all(), n
        assert not _f32(g["k"])[:, 0].any() and not _f32(g["ks"])[:, 0].any()
        return
    for n in ("k", "v"):
        a, b_ = _f32(g[n]), np.asarray(w[n], np.float32)
        atol = POOL_ATOL.get(kv, 0.0) or np.abs(b_) * 2.0 ** -8
        assert (np.abs(a - b_) <= atol + 1e-30).all(), n
        assert not a[:, 0].any(), "the garbage block was written"


def _port_prefill(s, kv):
    """Contiguous caches [stack, B, CAP, h, dh] of the prompts, each row
    prefilled at its own length (fp32 gather), stored at ``kv``; and the
    first token (the prefill's argmax)."""
    prefill_fn, _ = build_serve_steps(s["model_t"], TOPO, MiCSConfig(gather_dtype=torch.float32),
                                      CAP, device="cpu")
    caches = lm.init_caches(s["model_t"], B, CAP, dtype=KV_TORCH[kv], device="cpu")
    tok0 = np.zeros(B, np.int64)
    for b, n in enumerate(PLENS):
        logits, c = prefill_fn(s["params_t"], {"tokens": torch.as_tensor(s["prompts"][b:b + 1, :n])})
        for name in ("k", "v"):
            caches["layers"][name][:, b] = c["layers"][name][:, 0].to(KV_TORCH[kv])
        tok0[b] = int(torch.argmax(logits[0, -1, :s["model_t"].cfg.vocab]))
    return caches, tok0


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_equals_contiguous_bitwise(setup, kv, bs):
    """The reference's ``paged_bitwise`` cells within the port: the paged
    step over a pool filled by ``pages_from_contiguous`` against the
    contiguous vector-position step, greedy and sampled rows side by side:
    tokens and logits bit for bit."""
    model = setup["model_t"]
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype=kv, kv_block_size=bs)
    caches, tok0 = _port_prefill(setup, kv)
    tables, nb = _tables(bs)
    mb = -(-CAP // bs)
    tables = np.pad(tables, ((0, 0), (0, mb - tables.shape[1])))
    pool = PG.init_paged_caches(model, TOPO, nb, bs, kv, device="cpu")
    PG.pages_from_contiguous(model, TOPO, caches, pool, tables, PLENS, block_size=bs,
                             kv_dtype=kv)
    paged = PG.build_paged_step(model, TOPO, mcfg, max_blocks=mb, block_size=bs, device="cpu")
    contig = PG.build_contiguous_step(model, TOPO, mcfg, CAP, device="cpu")
    tp, tc = tok0.copy(), tok0.copy()
    pos = np.asarray(PLENS)
    for s in range(STEPS):
        t1, l1, pool = paged(setup["params_t"], pool, tp[:, None], pos + s, np.ones(B), tables,
                             SEEDS, MIXED_TEMPS)
        t2, l2, caches = contig(setup["params_t"], caches, tc[:, None], pos + s, SEEDS,
                                MIXED_TEMPS)
        assert torch.equal(t1, t2), s
        assert torch.equal(l1, l2), s
        tp, tc = t1.numpy(), t2.numpy()


def _stream(step, s, width, first_n, pool, tables):
    """Stream the prompts through ``step``: a first chunk of ``first_n[b]``
    tokens a row, then chunks of ``width``; returns each row's last (token,
    logits) and the pool."""
    plens = np.asarray(PLENS)
    done = np.zeros(B, np.int64)
    nxt = np.minimum(plens, first_n)
    last_t, last_l = [None] * B, [None] * B
    while (done < plens).any():
        toks = np.zeros((B, width), np.int64)
        for b in range(B):
            toks[b, :nxt[b]] = s["prompts"][b, done[b]:done[b] + nxt[b]]
        t, lg, pool = step(s["params_t"], pool, toks, done, nxt, tables, SEEDS,
                           np.zeros(B, np.float32))
        for b in range(B):
            if nxt[b] and done[b] + nxt[b] == plens[b]:
                last_t[b], last_l[b] = t[b].clone(), lg[b].clone()
        done = done + nxt
        nxt = np.minimum(plens - done, width)
    return torch.stack(last_t), torch.stack(last_l), pool


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
def test_chunk_placement_is_bitwise_irrelevant(setup, kv):
    """At a fixed chunk width where a prompt's chunk boundaries fall does
    not change a bit of its last logits, its token or the pool; across
    widths (4 against token by token) greedy tokens agree and the logits
    match to rounding (the reference's ``chunked_prefill``)."""
    model, bs = setup["model_t"], 4
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype=kv, kv_block_size=bs)
    tables, nb = _tables(bs)
    steps = {w: PG.build_paged_step(model, TOPO, mcfg, max_blocks=tables.shape[1],
                                    block_size=bs, chunk=w, device="cpu") for w in (4, 1)}

    def run(width, first_n):
        pool = PG.init_paged_caches(model, TOPO, nb, bs, kv, device="cpu")
        return _stream(steps[width], setup, width, first_n, pool, tables)

    ta, la, pa = run(4, np.full(B, 4))
    tb, lb, pb = run(4, 1 + np.arange(B) % 4)        # staggered boundaries
    assert torch.equal(ta, tb) and torch.equal(la, lb)
    for n in pa["layers"]:
        assert torch.equal(pa["layers"][n], pb["layers"][n]), n
    t1, l1, _ = run(1, np.ones(B, np.int64))
    assert torch.equal(ta, t1)
    np.testing.assert_allclose(_f32(la), _f32(l1), rtol=0, atol=1e-5 if kv == "fp32" else 5e-2)


def test_pages_from_contiguous_int8_rows(setup):
    """int8 pools take each (token, head) row quantized on its own: the
    pages hold ``quantize_flat`` of the contiguous cache's rows, block 0
    stays zero."""
    caches, _ = _port_prefill(setup, "fp32")
    tables, nb = _tables(4)
    pool = PG.init_paged_caches(setup["model_t"], TOPO, nb, 4, "int8", device="cpu")
    PG.pages_from_contiguous(setup["model_t"], TOPO, caches, pool, tables, PLENS, block_size=4,
                             kv_dtype="int8")
    lay = pool["layers"]
    for b, n in enumerate(PLENS):
        q, sc = Q.quantize_flat(caches["layers"]["k"][:, b, :n])
        posn = np.arange(n)
        assert torch.equal(lay["k"][:, tables[b, posn // 4], posn % 4], q)
        assert torch.equal(lay["ks"][:, tables[b, posn // 4], posn % 4], sc)
    assert not lay["k"][:, 0].any() and not lay["ks"][:, 0].any()


# ---------------------------------------------------------------------------
# the paged route's plain version
# ---------------------------------------------------------------------------

def _pages(gen, nb, bs, hkv, dh, dtype):
    return (torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype),
            torch.randn(nb, bs, hkv, dh, generator=gen).to(dtype))


@pytest.mark.parametrize("pages", ["bf16", "fp32", "int8"])
def test_paged_attention_plain_matches_gathered_view(pages):
    """A pool read through its tables (a shared block, the garbage block,
    ragged per-row lengths of a 3-token chunk) equals ``attention_plain``
    on the view gathered key by key, bitwise, and the reference's
    ``layers.attention`` with the same [b, tq] valid lengths within fp32
    rounding."""
    gen = torch.Generator().manual_seed(3)
    b, tq, hkv, g, dh, bs, mb, nb = 3, 3, 2, 2, 16, 4, 5, 9
    dt = torch.float32 if pages == "fp32" else torch.bfloat16
    k_pages, v_pages = _pages(gen, nb, bs, hkv, dh, torch.float32)
    scales = {}
    if pages == "int8":
        (k_pages, ks), (v_pages, vs) = Q.quantize_flat(k_pages), Q.quantize_flat(v_pages)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k_pages, v_pages = k_pages.to(dt), v_pages.to(dt)
    tables = torch.tensor([[3, 1, 0, 0, 0], [2, 5, 6, 7, 8], [4, 1, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([5, 17, 0])
    kvl = pos[:, None] + torch.arange(1, tq + 1)[None, :]
    q = torch.randn(b, tq, hkv, g, dh, generator=gen).to(dt)
    got = FA.paged_attention(q, k_pages, v_pages, tables, kvl, **scales)
    assert torch.equal(got, FA.paged_attention_plain(q, k_pages, v_pages, tables, kvl, **scales))

    def view(p, s=None):
        rows = [[p[tables[r, j // bs], j % bs] for j in range(mb * bs)] for r in range(b)]
        out = torch.stack([torch.stack(r) for r in rows])
        if s is None:
            return out
        sv = torch.stack([torch.stack([s[tables[r, j // bs], j % bs] for j in range(mb * bs)])
                          for r in range(b)])
        return Q.dequantize_flat(out, sv, dt)

    k = view(k_pages, scales.get("k_scale"))
    v = view(v_pages, scales.get("v_scale"))
    assert torch.equal(got, FA.attention_plain(q, k, v, causal=False, kv_valid_len=kvl))
    jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (q, k, v))
    want = JL.attention(jq.astype(jnp.float32), jk, jv, causal=False,
                        kv_valid_len=jnp.asarray(kvl.numpy()))
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), rtol=0,
                               atol=2e-2 if dt == torch.bfloat16 else 1e-6)
    # a contiguous cache is the pool of one block a request
    assert torch.equal(FA.flash_attention(q, k, v, causal=False, kv_valid_len=kvl),
                       FA.attention_plain(q, k, v, causal=False, kv_valid_len=kvl))


def test_paged_route_rules():
    assert FA.paged_route(torch.bfloat16, torch.bfloat16) == "paged"
    assert FA.paged_route(torch.bfloat16, torch.int8) == "paged"
    for qd, kd in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16)):
        with pytest.raises(NotImplementedError, match="fp32 KV pools on the card"):
            FA.paged_route(qd, kd)
    q = torch.zeros(1, 1, 1, 1, 16)
    with pytest.raises(ValueError, match="causal"):
        FA.flash_attention(q, q[:, :, :, 0], q[:, :, :, 0], kv_valid_len=torch.ones(1))
    with pytest.raises(ValueError, match="scale pages"):
        pages = torch.zeros(2, 4, 1, 16, dtype=torch.int8)
        FA.paged_attention(q, pages, pages, torch.zeros(1, 1, dtype=torch.int32), torch.ones(1))


# ---------------------------------------------------------------------------
# the seeded sampler
# ---------------------------------------------------------------------------

CTX = Ctx()


def _sample(logits, seed, pos, temp, top_k=0, vocab=None):
    b = logits.shape[0]
    return lm.sample_tokens(logits, CTX, vocab or logits.shape[-1],
                            seed=torch.as_tensor(seed).expand(b),
                            pos=torch.as_tensor(pos).expand(b),
                            temperature=torch.as_tensor(temp, dtype=torch.float32).expand(b),
                            top_k=top_k)


def test_sampler_temperature_zero_is_greedy():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(16, 300, generator=gen)
    logits[3, 7] = logits[3, 9] = 50.0       # a tie: the first column
    greedy = lm.greedy_sample(logits, CTX, 290)
    for top_k in (0, 5):
        got = _sample(logits, torch.arange(16), torch.arange(16) + 40, 0.0, top_k, vocab=290)
        assert torch.equal(got, greedy)
    assert int(greedy[3]) == 7


def test_sampler_draw_is_a_function_of_seed_and_position():
    """The same (seed, position) draws the same token in any slot, batch or
    call; another seed or position draws other noise."""
    gen = torch.Generator().manual_seed(1)
    row = torch.randn(1, 500, generator=gen)
    one = _sample(row, 11, 40, 1.0)
    batch = row.expand(6, 500).contiguous()
    seeds = torch.tensor([3, 11, 5, 11, 11, 2])
    pos = torch.tensor([40, 40, 40, 41, 40, 9])
    got = lm.sample_tokens(batch, CTX, 500, seed=seeds, pos=pos,
                           temperature=torch.ones(6), top_k=0)
    assert int(got[1]) == int(got[4]) == int(one)
    g = lm.gumbel_noise(seeds, pos, 500)
    assert torch.equal(g[1], g[4])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[1], g[3])
    # draws over 64 seeds: distinct streams, roughly uncorrelated noise
    many = lm.gumbel_noise(torch.arange(64), torch.full((64,), 7), 500)
    corr = np.corrcoef(many.numpy())[np.triu_indices(64, 1)]
    assert np.abs(corr).max() < 0.25


def test_sampler_law_is_softmax_over_top_k():
    """Chi-square of 20,000 draws (seeds 0..19999 at one position) against
    softmax(logits / T) on a vocabulary of 8; with top_k 3 every draw is in
    the exact top 3 and their law is the renormalised softmax."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, 1.5, -1.0, 0.7]])
    n, temp = 20_000, 0.8
    draws = lm.sample_tokens(logits.expand(n, 8).contiguous(), CTX, 8,
                             seed=torch.arange(n), pos=torch.full((n,), 3),
                             temperature=torch.full((n,), temp), top_k=0)
    p = torch.softmax(logits[0] / temp, -1).numpy()
    counts = np.bincount(draws.numpy(), minlength=8)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.3, (chi2, counts)       # chi-square, 7 dof, p = 0.001
    top = lm.sample_tokens(logits.expand(n, 8).contiguous(), CTX, 8,
                           seed=torch.arange(n), pos=torch.full((n,), 3),
                           temperature=torch.full((n,), temp), top_k=3)
    assert set(np.unique(top.numpy())) == {3, 5, 0}
    keep = torch.softmax(logits[0, [0, 3, 5]] / temp, -1).numpy()
    counts = np.bincount(top.numpy(), minlength=8)[[0, 3, 5]]
    chi2 = float(((counts - n * keep) ** 2 / (n * keep)).sum())
    assert chi2 < 13.8, (chi2, counts)       # 2 dof, p = 0.001


def test_sampler_refuses_vocab_parallel_logits():
    class Comm:
        def model_coord(self):
            return 0

    with pytest.raises(NotImplementedError, match="item 6b"):
        lm.sample_tokens(torch.zeros(1, 4), Ctx(tp=2, comm=Comm()), 8, seed=torch.zeros(1),
                         pos=torch.zeros(1), temperature=torch.ones(1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_cuda_paged_route_matches_plain(cuda_device, pages):
    """The ``paged`` route at a decode tick and a 9-token chunk (ragged
    lengths, a shared and an unset block) against its plain version on the
    same card tensors (the split route's bf16 tolerance), bitwise
    repeatable, and the contiguous form (a one-block-a-request pool) bitwise
    the paged one."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b, hkv, g, dh, bs, mb, nb = 4, 2, 4, 64, 16, 6, 30
    k_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=cuda_device)
    v_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=cuda_device)
    scales = {}
    if pages == "int8":
        (k_pages, ks), (v_pages, vs) = Q.quantize_flat(k_pages), Q.quantize_flat(v_pages)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k_pages, v_pages = k_pages.to(torch.bfloat16), v_pages.to(torch.bfloat16)
    tables = torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 0, 0, 0, 0], [9, 2, 10, 11, 0, 0],
                           [12, 13, 14, 15, 16, 17]], dtype=torch.int32, device=cuda_device)
    for tq, pos in ((1, [90, 20, 50, 95]), (9, [40, 0, 33, 87])):
        q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(torch.bfloat16)
        kvl = torch.tensor(pos, device=cuda_device)[:, None] + torch.arange(
            1, tq + 1, device=cuda_device)[None, :]
        got = FA.paged_attention(q, k_pages, v_pages, tables, kvl, **scales)
        want = FA.paged_attention_plain(q, k_pages, v_pages, tables, kvl, **scales)
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), rtol=2e-2, atol=2e-2)
        assert torch.equal(got, FA.paged_attention(q, k_pages, v_pages, tables, kvl, **scales))
