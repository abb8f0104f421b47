"""The ``paged`` route's rules on the CPU: the dead-row convention of
``paged_attention`` / ``paged_attention_plain`` (a row of valid length 0
gives exact zeros and leaves every other row's bits as they were), the
split plan (a function of the shapes alone), the body a head dim takes,
and the engine's call site (rows past a slot's ``n_new`` are dead).  The
live rows are held to the reference's ``layers.attention`` over the
gathered view.  On the card (``gpu``): the ``paged`` and ``split`` routes
at a rank's shapes when serving over ranks (llama's KV heads over tp 2, 4
and 8; recurrentgemma's one KV head of g 3 at dh 256 over tp 4) against
their plain versions."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

# b, tq, hkv, g, dh, block size, blocks a table, blocks in the pool
SHAPE = (4, 6, 2, 2, 16, 4, 5, 12)


def _inputs(pages: str, seed: int = 0):
    """A pool, its tables (shared and garbage blocks), q and the live
    lengths of a 6-token chunk a slot, all from a numpy seed.  ``pages``:
    bf16, int8 (bf16 q), fp32 (fp32 q) or fp32:bq (fp32 pages, bf16 q: the
    engine's fp32 pools under bf16 compute)."""
    q_bf16 = pages != "fp32"
    pages = pages.split(":")[0]
    b, tq, hkv, g, dh, bs, mb, nb = SHAPE
    rng = np.random.default_rng(seed)
    kp = torch.as_tensor(rng.standard_normal((nb, bs, hkv, dh)), dtype=torch.float32)
    vp = torch.as_tensor(rng.standard_normal((nb, bs, hkv, dh)), dtype=torch.float32)
    scales = {}
    if pages == "int8":
        (kp, ks), (vp, vs) = Q.quantize_flat(kp), Q.quantize_flat(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        dt = torch.float32 if pages == "fp32" else torch.bfloat16
        kp, vp = kp.to(dt), vp.to(dt)
    dt = torch.bfloat16 if q_bf16 else torch.float32
    q = torch.as_tensor(rng.standard_normal((b, tq, hkv, g, dh)), dtype=torch.float32).to(dt)
    tables = torch.tensor([[3, 1, 0, 0, 0], [2, 5, 6, 7, 8], [4, 1, 9, 0, 0], [10, 11, 0, 0, 0]],
                          dtype=torch.int32)
    pos = torch.tensor([5, 13, 2, 0])
    kvl = pos[:, None] + torch.arange(1, tq + 1)[None, :]
    return q, kp, vp, tables, kvl, scales


# n_new a slot: a full chunk, a decode row, an idle slot, three rows
N_NEW = torch.tensor([6, 1, 0, 3])


def _dead(kvl):
    """The engine's lengths: rows at or past a slot's n_new get 0."""
    tq = kvl.shape[1]
    return torch.where(torch.arange(tq)[None, :] < N_NEW[:, None], kvl, 0)


@pytest.mark.parametrize("pages", ["bf16", "fp32", "fp32:bq", "int8"])
def test_dead_rows_are_zero_and_leave_live_rows_bitwise(pages):
    q, kp, vp, tables, kvl, sc = _inputs(pages)
    dead_kvl = _dead(kvl)
    got = FA.paged_attention_plain(q, kp, vp, tables, dead_kvl, **sc)
    dead = dead_kvl == 0
    assert dead.any() and (~dead).any()
    assert (got[dead] == 0).all() and not got[dead].signbit().any()
    # the live rows: the bits of the call where the dead rows see 1 key, or
    # their full lengths
    for other in (torch.where(dead, 1, kvl), kvl):
        want = FA.paged_attention_plain(q, kp, vp, tables, other, **sc)
        assert torch.equal(got[~dead], want[~dead])
    # the wrapper takes the plain version on the CPU
    assert torch.equal(FA.paged_attention(q, kp, vp, tables, dead_kvl, **sc), got)


@pytest.mark.parametrize("pages", ["bf16", "fp32", "fp32:bq", "int8"])
def test_live_rows_match_reference_attention(pages):
    """Live rows against the reference's ``layers.attention`` over the view
    gathered (and dequantized) by hand with the same per-row lengths
    (the reference has no dead rows: it gives a dead row the mean of v).
    fp32 pages keep fp32 (the reference's ``_paged_kv_read``) and give fp32
    rows whatever q's type, as the reference's promotion does."""
    q, kp, vp, tables, kvl, sc = _inputs(pages, seed=1)
    dead_kvl = _dead(kvl)
    got = FA.paged_attention(q, kp, vp, tables, dead_kvl, **sc)
    b, bs = tables.shape[0], kp.shape[1]
    idx = tables.long()
    k, v = kp[idx].reshape(b, -1, *kp.shape[2:]), vp[idx].reshape(b, -1, *vp.shape[2:])
    if sc:
        ks = sc["k_scale"][idx].reshape(b, -1, *sc["k_scale"].shape[2:])
        vs = sc["v_scale"][idx].reshape(b, -1, *sc["v_scale"].shape[2:])
        k, v = Q.dequantize_flat(k, ks, q.dtype), Q.dequantize_flat(v, vs, q.dtype)
    jk, jv = jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy())
    want = np.asarray(JL.attention(jnp.asarray(q.float().numpy()), jk, jv, causal=False,
                                   kv_valid_len=jnp.asarray(dead_kvl.numpy())), np.float32)
    live = (dead_kvl != 0).numpy()
    atol = 2e-2 if q.dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy()[live], want[live], rtol=0, atol=atol)
    assert got.dtype == torch.promote_types(q.dtype, kp.dtype if not sc else q.dtype)
    assert not got.float().numpy()[~live].any()


@pytest.mark.parametrize("b,hkv,capacity", [
    (8, 8, 576),      # the engine: 8 slots x llama's 8 KV heads, 36 blocks of 16
    (4, 2, 96),
    (4, 8, 16),
    (1, 1, 100_000),
    (64, 8, 4096),
    (3, 5, 1000),
])
def test_paged_plan_is_a_function_of_shapes(b, hkv, capacity):
    nsplit, chunk = FA.plan_paged_splits(b, hkv, capacity)
    assert chunk % FK.PAGED_KEYS == 0 and chunk >= FK.PAGED_KEYS
    # every split inside the capacity, which they cover
    assert (nsplit - 1) * chunk < capacity <= nsplit * chunk
    # one live row block a (batch row, KV head), a decode-only tick at any
    # width, fills the card: about two blocks a SM, unless the smallest
    # chunk already stops the split
    assert b * hkv * nsplit >= 0.95 * 2 * 132 or chunk == FK.PAGED_KEYS
    assert FA.plan_paged_splits(b, hkv, capacity, sms=132) == (nsplit, chunk)
    if (b, hkv, capacity) == (8, 8, 576):
        assert (nsplit, chunk) == (5, 128)


def test_paged_plan_is_the_split_plan_in_whole_tiles():
    for b, hkv, cap in ((8, 8, 576), (2, 1, 300), (16, 4, 2048)):
        nsplit, chunk = FA.plan_paged_splits(b, hkv, cap)
        assert (nsplit, chunk) == FA.plan_decode_splits(b, hkv, cap, multiple=FK.PAGED_KEYS)


@pytest.mark.parametrize("dh,body", [(16, "mma"), (32, "mma"), (64, "wgmma"), (128, "wgmma"),
                                     (256, "mma")])
def test_paged_body_by_head_dim(dh, body):
    assert FA.paged_body(dh) == body
    assert FA.paged_body(dh, torch.int8) == body
    assert FA.paged_body(dh, torch.float32) == "fma"   # fp32 pages: CUDA cores, any dh
    assert f"paged:{body}" in FK.launches_paged_by_form
    assert "paged:fma" in FK.launches_paged_by_form


def test_cpu_call_counts_no_launch():
    q, kp, vp, tables, kvl, sc = _inputs("bf16")
    before = (FK.launches, dict(FK.launches_by_route), dict(FK.launches_paged_by_form))
    FA.paged_attention(q, kp, vp, tables, kvl)
    assert (FK.launches, FK.launches_by_route, FK.launches_paged_by_form) == before


def test_paged_bench_imports_no_jax():
    """``tools/paged_bench.py`` times the port on the card: it imports
    neither JAX nor the JAX package."""
    import ast
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "paged_bench.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "repro"}, names
    assert "repro_torch" in names and "chip_smoke" in names


def test_engine_step_passes_dead_rows(monkeypatch):
    """The paged step's call site (``models/blocks.py``): row i of slot b
    reaches attention with valid length ``pos + i + 1`` below the slot's
    ``n_new`` and 0 at or past it (an idle slot's every row), in every
    layer; the last consumed row of each slot is live."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import layers as L
    from repro_torch.models.build import build_model
    from repro_torch.runtime import paged as PG

    torch.manual_seed(0)
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    params = init_params(model, seed=3, device="cpu")
    bs, mb, width = 4, 4, 4
    topo = MiCSTopology()
    step = PG.build_paged_step(model, topo, MiCSConfig(gather_dtype=torch.float32), max_blocks=mb,
                               block_size=bs, chunk=width, device="cpu")
    pool = PG.init_paged_caches(model, topo, 4 * mb + 1, bs, "bf16", device="cpu")
    tables = np.arange(1, 4 * mb + 1, dtype=np.int32).reshape(4, mb)
    pos, n_new = np.array([0, 5, 7, 2]), np.array([4, 1, 0, 2])
    seen = []
    real = L.paged_attention

    def spy(q, k, v, tables, kv_valid_len, **kw):
        seen.append(kv_valid_len.clone())
        return real(q, k, v, tables, kv_valid_len, **kw)

    monkeypatch.setattr(L, "paged_attention", spy)
    toks = np.arange(16).reshape(4, width) % model.cfg.vocab + 1
    step(params, pool, toks, pos, n_new, tables, np.zeros(4), np.zeros(4, np.float32))
    rows = torch.arange(width)[None, :]
    want = torch.where(rows < torch.as_tensor(n_new)[:, None],
                       torch.as_tensor(pos)[:, None] + rows + 1, 0)
    assert len(seen) == model.cfg.n_layers
    for got in seen:
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card: a rank's shapes when serving over ranks
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# llama3.2-1b's 8 KV heads of g 4 at dh 64 over tp 2 / 4 / 8 model ranks
RANK_KV_HEADS = (4, 2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("hkv", RANK_KV_HEADS)
def test_cuda_paged_route_at_rank_shapes(cuda_device, pages, hkv):
    """The ``paged`` route at a rank's shapes of the engine over ranks
    (``chip_smoke.py``'s ``dist_serve``: 4 slots, a 64-token chunk width,
    blocks of 16, 17 a table): a decode-only tick (one live row a slot), a
    mixed tick and a full chunk, against its plain version on the same card
    tensors (the split route's bf16 tolerance); dead rows exactly zero;
    bitwise repeatable; its ``wgmma`` body."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(7)
    b, g, dh, bs, mb, w = 4, 4, 64, 16, 17, 64
    nb = b * mb + 1
    order = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(3)) + 1
    tables = order[:b * mb].reshape(b, mb).to(torch.int32).to(dev)
    k_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=dev)
    v_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=dev)
    scales = {}
    if pages == "int8":
        (k_pages, ks), (v_pages, vs) = Q.quantize_flat(k_pages), Q.quantize_flat(v_pages)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k_pages, v_pages = k_pages.to(torch.bfloat16), v_pages.to(torch.bfloat16)
    rows = torch.arange(1, w + 1, device=dev)[None, :]
    pos = torch.tensor([150, 201, 90, 255], device=dev)[:, None]
    n_new = torch.tensor([w, 1, 1, 0], device=dev)[:, None]
    for kvl in (torch.where(rows == 1, pos + rows, 0),
                torch.where(rows <= n_new, torch.tensor([0, 201, 90, 0], device=dev)[:, None]
                            + rows, 0),
                torch.tensor([0, 64, 128, 192], device=dev)[:, None] + rows):
        q = torch.randn(b, w, hkv, g, dh, generator=gen, device=dev).to(torch.bfloat16)
        before = FK.launches_paged_by_form["paged:wgmma"]
        got = FA.paged_attention(q, k_pages, v_pages, tables, kvl, **scales)
        assert FK.launches_paged_by_form["paged:wgmma"] == before + 1
        want = FA.paged_attention_plain(q, k_pages, v_pages, tables, kvl, **scales)
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
        assert not got[kvl == 0].any()
        assert torch.equal(got, FA.paged_attention(q, k_pages, v_pages, tables, kvl, **scales))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("hkv,g,dh", [(8, 4, 64), (16, 1, 128), (8, 6, 128), (1, 3, 256),
                                      (2, 2, 16)])
def test_cuda_paged_fma_body(cuda_device, q_dtype, hkv, g, dh):
    """The ``paged`` route's ``fma`` body (fp32 pages) against its plain
    version: a decode-only tick, a mixed tick and a full chunk at 4 slots,
    blocks of 16, llama's, deepseek's, dbrx's, recurrentgemma's and a
    small head shape; fp32 out within fp32's tolerance; dead rows zero;
    bitwise repeatable; counted on ``paged:fma``."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(9)
    b, bs, mb, w = 4, 16, 17, 16
    nb = b * mb + 1
    order = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(4)) + 1
    tables = order[:b * mb].reshape(b, mb).to(torch.int32).to(dev)
    k_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=dev)
    v_pages = torch.randn(nb, bs, hkv, dh, generator=gen, device=dev)
    qdt = torch.bfloat16 if q_dtype == "bf16" else torch.float32
    rows = torch.arange(1, w + 1, device=dev)[None, :]
    pos = torch.tensor([150, 201, 90, 255], device=dev)[:, None]
    n_new = torch.tensor([w, 1, 1, 0], device=dev)[:, None]
    for kvl in (torch.where(rows == 1, pos + rows, 0),
                torch.where(rows <= n_new, pos + rows, 0),
                torch.tensor([0, 64, 128, 192], device=dev)[:, None] + rows):
        q = torch.randn(b, w, hkv, g, dh, generator=gen, device=dev).to(qdt)
        before = FK.launches_paged_by_form["paged:fma"]
        got = FA.paged_attention(q, k_pages, v_pages, tables, kvl)
        assert FK.launches_paged_by_form["paged:fma"] == before + 1
        assert got.dtype == torch.float32
        want = FA.paged_attention_plain(q, k_pages, v_pages, tables, kvl)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)
        assert not got[kvl == 0].any()
        assert torch.equal(got, FA.paged_attention(q, k_pages, v_pages, tables, kvl))


@pytest.mark.gpu
@pytest.mark.parametrize("hkv,g,dh,window,tk,kv_len", [
    (4, 4, 64, 0, 544, 520),        # llama at tp 2, a fixed-batch decode step
    (2, 4, 64, 0, 544, 520),        # llama at tp 4
    (1, 4, 64, 0, 544, 520),        # llama at tp 8: one KV head a rank
    (1, 3, 256, 0, 520, 520),       # recurrentgemma at tp 4 (10 Q heads padded to 12)
    (1, 3, 256, 0, 2048, 2048),     # the same past its 2048 window: a full rolled cache
])
def test_cuda_split_decode_at_rank_shapes(cuda_device, hkv, g, dh, window, tk, kv_len):
    """The ``split`` route (bf16 decode, one query row a KV head's g heads)
    at a rank's shapes, batch 4, against its plain version; bitwise
    repeatable; counted on ``split``."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(4, 1, hkv, g, dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(4, tk, hkv, dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(4, tk, hkv, dh, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(causal=False, window=window, q_offset=0, kv_valid_len=kv_len)
    assert FK.route(torch.bfloat16, g) == "split"
    before = FK.launches_by_route["split"]
    got = FA.flash_attention(q, k, v, **kw)
    assert FK.launches_by_route["split"] == before + 1
    want = FK.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(got, FA.flash_attention(q, k, v, **kw))
