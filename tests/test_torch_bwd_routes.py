"""The routes of the port's backward kernels.

On the CPU: the route rules of ``flash_attention_bwd`` (``bwd_route``:
``wgmma`` / ``wgmma256`` / ``mma`` / ``fma`` by dtype, head dim, group
size and KV heads; ``bwd_routes``, the routes ``flash_attention_bwd_on``
takes) and of ``rmsnorm_bwd`` (``bwd_route``: ``regs`` / ``smem`` by dtype,
row width and alignment) as pure functions, the padded row count of the
flash backward's (lse, delta) table, and which RG-LRU calls run as its
autograd Function.  On the card (``gpu`` marker, skipped here): each route
against its plain version at the train paths' shapes and at its edges,
bitwise repeatable, and the RG-LRU backward, through its Function, against
its plain version.  The plain versions themselves are held to ``jax.vjp``
of the JAX package's functions in ``tests/test_torch_grads.py`` and
``tests/test_torch_rglru_grad.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.rglru import kernel as RG  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RN  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# route rules (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dh,g,hkv,want", [
    (BF, 64, 4, 8, "wgmma"),       # llama3.2-1b: GQA 32 / 8 heads of 64
    (BF, 64, 1, 4, "wgmma"),
    (BF, 128, 8, 2, "wgmma"),
    (BF, 64, 64, 1, "wgmma"),      # one position a 64-row tile
    (BF, 64, 3, 2, "mma"),         # 64 rows are not whole positions
    (BF, 64, 3, 1, "mma"),         # one KV head opens only dh 256's route
    (BF, 128, 10, 1, "mma"),       # recurrentgemma's MQA group at another head dim
    (BF, 64, 128, 1, "mma"),
    (BF, 32, 4, 2, "mma"),         # head dims a 128-byte TMA row does not hold
    (BF, 16, 1, 2, "mma"),
    (F32, 64, 4, 8, "fma"),
    (F32, 256, 10, 1, "fma"),
    (BF, 256, 10, 1, "wgmma256"),  # recurrentgemma-2b: MQA 10 heads of 256
    (BF, 256, 3, 1, "wgmma256"),   # one KV head: rows [b, T g, dh], any g
    (BF, 256, 10, 2, "mma"),       # two KV heads, g not dividing 64: column halves
    (BF, 256, 1, 4, "wgmma256"),   # g dividing 64: whole positions a box
    (BF, 256, 64, 2, "wgmma256"),
    (BF, 256, 3, 2, "mma"),
])
def test_flash_bwd_route(dtype, dh, g, hkv, want):
    assert FA.bwd_route(dtype, dh, g, hkv) == want
    # flash_attention_bwd_on takes the rule's route and, for bf16, mma
    assert FA.bwd_routes(dtype, dh, g, hkv) == (
        (want,) if want in ("mma", "fma") else (want, "mma"))


def test_flash_bwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        FA.bwd_route(torch.float16, 64, 4, 8)


def test_flash_bwd_on_refuses_a_route_the_shape_does_not_take():
    """A route outside ``bwd_routes`` raises before any launch, on the CPU
    too (where a route it takes runs the plain version)."""
    q = torch.zeros(1, 4, 1, 10, 256, dtype=BF)
    k = torch.zeros(1, 4, 1, 256, dtype=BF)
    lse = torch.zeros(1, 1, 10, 4)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        FA.flash_attention_bwd_on("wgmma", q, k, k, q, lse, q)
    want = FA.flash_attention_bwd_plain(q, k, k, q, lse, q)
    for r in ("wgmma256", "mma"):
        got = FA.flash_attention_bwd_on(r, q, k, k, q, lse, q)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("tq,g,want", [(2048, 4, 8192), (300, 1, 300), (301, 1, 302),
                                       (3, 3, 10), (1, 1, 2)])
def test_rowstat_rows_is_even_and_covers_the_rows(tq, g, want):
    assert FA.rowstat_rows(tq, g) == want


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (BF, 2048, True, "regs"),   # llama3.2-1b's d_model
    (BF, 256, True, "regs"),
    (BF, 768, True, "regs"),
    (BF, 2048, False, "smem"),  # a row that starts off 16 bytes
    (BF, 2560, True, "smem"),   # wider than a lane's registers hold
    (BF, 1000, True, "smem"),   # not whole 16-byte vectors a lane
    (BF, 128, True, "smem"),
    (F32, 2048, True, "smem"),
])
def test_rmsnorm_bwd_route(dtype, d, aligned, want):
    assert RN.bwd_route(dtype, d, aligned) == want


def test_rmsnorm_bwd_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        RN.bwd_route(torch.float16, 2048, True)


def test_rglru_needs_grad():
    """A call autograd records (grad mode on, some input requiring grad)
    runs as the RG-LRU's autograd Function; any other call launches the
    forward alone."""
    x = torch.zeros(2, 3, 4)
    ws = [torch.zeros(4) for _ in range(5)]
    w = torch.zeros(4, requires_grad=True)
    assert "RgLruGatedFn" in type(RG.rglru_gated(x, w, *ws[1:])[0].grad_fn).__name__
    assert "RgLruFn" in type(RG.rglru(x, x.clone().requires_grad_()).grad_fn).__name__
    assert RG.rglru_gated(x, *ws)[0].grad_fn is None
    with torch.no_grad():
        assert RG.rglru_gated(x, w, *ws[1:])[0].grad_fn is None


def test_rglru_cpu_calls_stay_differentiable():
    """On the CPU a call autograd records runs the Function over the plain
    versions, and its gradient reaches every weight (``h_last`` carries
    none)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=gen, requires_grad=True)
    ws = [(0.1 * torch.randn(8, generator=gen)).requires_grad_() for _ in range(5)]
    h, h_last = RG.rglru_gated(x, *ws)
    (h.sum() + h_last.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (x, *ws))


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel_close(got, want, rel, what):
    """max |got - want| <= rel * max |want|, on the CPU in fp32."""
    g, w = got.float().cpu(), want.float().cpu()
    err, scale = (g - w).abs().max().item(), w.abs().max().item()
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"


# tests/test_torch_kernels.py's BWD_REL and chip_smoke.py's BWD_REL_TOL
BWD_REL = {BF: 2e-2, F32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kw", [
    ((4, 2048, 2048, 8, 4, 64), dict(causal=True)),                # llama train, one micro-step
    ((2, 300, 300, 2, 4, 64), dict(causal=True)),                  # ragged T
    ((2, 512, 512, 2, 4, 64), dict(causal=True, window=64)),
    ((2, 256, 256, 4, 1, 64), dict(causal=True)),                  # g 1
    ((2, 200, 200, 1, 8, 128), dict(causal=True)),                 # dh 128
    ((2, 300, 300, 2, 4, 128), dict(causal=True, window=50)),
    ((2, 160, 160, 2, 4, 64), dict(causal=False)),
    ((2, 128, 256, 2, 4, 64), dict(causal=True, q_offset=64, kv_valid_len=150)),
    ((2, 3, 40, 2, 2, 64), dict(causal=True, q_offset=30)),        # 6 rows
    ((1, 64, 64, 1, 64, 64), dict(causal=True)),                   # a position a tile
    ((2, 301, 301, 2, 1, 64), dict(causal=True, window=100)),      # odd row count: padded stats
    ((2, 200, 200, 2, 3, 64), dict(causal=True)),                  # g 3: refused, takes mma
])
def test_cuda_flash_bwd_wgmma_matches_plain(cuda_device, shape, kw):
    """The wgmma backward (or mma, where ``bwd_route`` refuses the group)
    against its plain version, bitwise repeatable, counted on its route."""
    b, tq, tk, hkv, g, dh = shape
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, do = (torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(BF)
             for _ in range(2))
    k, v = (torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(BF)
            for _ in range(2))
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    r = FA.bwd_route(BF, dh, g, hkv)
    assert r == ("mma" if 64 % g else "wgmma")
    before = dict(FA.launches_bwd_by_route)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert FA.launches_bwd_by_route[r] == before[r] + 2
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for got, rep, ref, what in zip(grads, again, want, ("dq", "dk", "dv")):
        assert torch.equal(got, rep), f"{what}: not bitwise repeatable"
        assert got.dtype == BF and got.shape == ref.shape
        _rel_close(got, ref, BWD_REL[BF], what)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,sdt,offset,want", [
    (8192, 2048, BF, 0, "regs"),      # llama train: 4 x 2048 tokens
    (64, 2048, F32, 0, "regs"),       # fp32 scale
    (3, 256, BF, 0, "regs"),          # fewer rows than a block's warps
    (1000, 768, BF, 0, "regs"),
    (8, 2048, BF, 1, "smem"),         # unaligned rows
    (37, 1000, BF, 0, "smem"),        # ragged d
    (16, 2560, BF, 0, "smem"),        # past the registers' d
])
def test_cuda_rmsnorm_bwd_routes_match_plain(cuda_device, n, d, sdt, offset, want):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    xb, gb = (torch.randn(n * d + offset, generator=gen, device=cuda_device).to(BF)
              for _ in range(2))
    s = (0.2 * torch.randn(d, generator=gen, device=cuda_device)).to(sdt)
    x, dy = xb[offset:].view(n, d), gb[offset:].view(n, d)
    before = dict(RN.launches_bwd_by_route)
    dx, ds = RN.rmsnorm_bwd(x, s, dy)
    dx2, ds2 = RN.rmsnorm_bwd(x, s, dy)
    assert RN.launches_bwd_by_route[want] == before[want] + 2
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    rdx, rds = RN.rms_norm_bwd_plain(x, s, dy)
    _rel_close(dx, rdx, BWD_REL[BF], "dx")
    _rel_close(ds, rds, BWD_REL[BF], "dscale")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dt,wdt", [
    ((2, 2048, 2560), BF, BF),      # recurrentgemma train, one micro-step: 32 chunks of 64
    ((3, 1001, 2500), BF, F32),     # T not a multiple of the chunk, C of 128
    ((2, 1, 300), BF, BF),          # T 1
    ((2, 700, 384), F32, F32),
])
def test_cuda_rglru_gated_grad_matches_plain(cuda_device, shape, dt, wdt):
    """A recorded call launches the kernel forward and, in the backward,
    the backward kernel (counted as a gated launch); the gradients agree
    with the plain backward and repeat bitwise."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    c = shape[2]
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dt)
    u = 0.9 + 0.099 * torch.rand(c, generator=gen, device=cuda_device)
    ws = [(0.5 * torch.randn(c, generator=gen, device=cuda_device)).to(wdt) for _ in range(4)]
    ws.append((torch.log(u) - torch.log1p(-u)).to(wdt))
    dh = torch.randn(shape, generator=gen, device=cuda_device).to(dt)
    plan = RG.plan_bwd_chunks(*shape, sms=torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    want = RG.rglru_gated_bwd_plain(x, *ws, dh, nchunks=plan[0], chunk_len=plan[1])
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_() for t in (x, *ws)]
        before = dict(RG.launches_bwd_by_form)
        h, _ = RG.rglru_gated(*ins)
        h.backward(dh)
        assert RG.launches_bwd_by_form == {"ab": before["ab"], "gated": before["gated"] + 1}
        runs.append([t.grad for t in ins])
    for got, rep, ref, what in zip(*runs, want, ("x", "wr", "br", "wi", "bi", "lam")):
        assert torch.equal(got, rep), f"d{what}: not bitwise repeatable"
        _rel_close(got, ref, BWD_REL[dt], f"d{what}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2048, 2560), (3, 1001, 2500), (2, 1, 300)])
def test_cuda_rglru_gated_starts_match_plain(cuda_device, shape):
    """The chunk starts the gated forward writes on the backward's plan
    against their plain version (fp32, within the forward's tolerance of
    max |start|), and the backward from them against the plain backward
    that folds its own."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    c = shape[2]
    x = torch.randn(shape, generator=gen, device=cuda_device).to(BF)
    u = 0.9 + 0.099 * torch.rand(c, generator=gen, device=cuda_device)
    ws = [(0.5 * torch.randn(c, generator=gen, device=cuda_device)).to(BF) for _ in range(4)]
    ws.append((torch.log(u) - torch.log1p(-u)).to(BF))
    dh = torch.randn(shape, generator=gen, device=cuda_device).to(BF)
    plan = RG.plan_bwd_chunks(*shape, sms=torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    h, _, starts = RG.rglru_gated_with_starts(x, *ws, plan=plan)
    assert starts.shape == (shape[0], plan[0], c) and starts.dtype == F32
    want = RG.rglru_gated_starts_plain(x, *ws, nchunks=plan[0], chunk_len=plan[1])
    _rel_close(starts, want, 1e-4, "starts")
    got = RG.rglru_gated_bwd(x, *ws, dh, plan=plan, h_starts=starts)
    for a, b, what in zip(got, RG.rglru_gated_bwd_plain(x, *ws, dh, nchunks=plan[0],
                                                        chunk_len=plan[1]),
                          ("x", "wr", "br", "wi", "bi", "lam")):
        _rel_close(a, b, BWD_REL[BF], f"d{what}")
    if plan[0] > 1:
        with pytest.raises(ValueError, match="chunk starts"):
            RG.rglru_gated_bwd(x, *ws, dh, plan=plan)


@pytest.mark.gpu
def test_cuda_rglru_ab_grad_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a = 0.7 + 0.299 * torch.rand(3, 1001, 2500, generator=gen, device=cuda_device)
    b = 0.1 * torch.randn(3, 1001, 2500, generator=gen, device=cuda_device)
    dh = torch.randn(3, 1001, 2500, generator=gen, device=cuda_device)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = dict(RG.launches_bwd_by_form)
    RG.rglru(a1, b1).backward(dh)
    assert RG.launches_bwd_by_form == {"ab": before["ab"] + 1, "gated": before["gated"]}
    plan = RG.plan_bwd_chunks(3, 1001, 2500, sms=torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    for got, ref, what in zip((a1.grad, b1.grad), RG.rglru_bwd_plain(
            a, b, dh, nchunks=plan[0], chunk_len=plan[1]), ("da", "db")):
        _rel_close(got, ref, BWD_REL[F32], what)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["rule", "mma"])
@pytest.mark.parametrize("shape,kw", [
    ((2, 2048, 2048, 1, 10, 256), dict(causal=True, window=2048)),  # recurrentgemma train
    ((2, 512, 512, 1, 10, 256), dict(causal=True, window=64)),
    ((2, 300, 300, 1, 10, 256), dict(causal=True)),                 # ragged T
    ((1, 77, 77, 2, 4, 256), dict(causal=True)),                    # g 4 divides 64
    ((2, 128, 256, 1, 10, 256), dict(causal=True, q_offset=64, kv_valid_len=150)),
    ((2, 200, 200, 1, 3, 256), dict(causal=True)),                  # one KV head, g 3
    ((1, 150, 150, 2, 10, 256), dict(causal=True, window=100)),     # the rule takes mma
    ((1, 100, 100, 1, 10, 256), dict(causal=False)),
])
def test_cuda_flash_bwd_dh256_matches_plain(cuda_device, route, shape, kw):
    """The dh-256 backward on the rule's route (``wgmma256`` where it
    takes the shape) and on ``mma`` (each block owning 128 of the 256
    output columns) against the plain version, bitwise repeatable, counted
    on its route."""
    b, tq, tk, hkv, g, dh = shape
    r = FA.bwd_route(BF, dh, g, hkv) if route == "rule" else route
    assert r == ("wgmma256" if route == "rule" and (hkv == 1 or 64 % g == 0) else "mma")
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, do = (torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(BF)
             for _ in range(2))
    k, v = (torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(BF)
            for _ in range(2))
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    before = FA.launches_bwd_by_route[r]
    grads = FA.flash_attention_bwd_on(r, q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd_on(r, q, k, v, o, lse, do, **kw)
    assert FA.launches_bwd_by_route[r] == before + 2
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for got, rep, ref, what in zip(grads, again, want, ("dq", "dk", "dv")):
        assert torch.equal(got, rep), f"{what}: not bitwise repeatable"
        _rel_close(got, ref, BWD_REL[BF], what)
