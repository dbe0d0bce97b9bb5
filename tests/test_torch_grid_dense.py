"""The port's ``grid`` and ``dense`` paged backends vs the JAX reference.

On the CPU: the grid decode kernel's plain version against the Pallas
``paged_decode_attention`` in interpret mode (a 128x length spread, a
dead slot, lengths at whole blocks, tables padded with a live block 0,
G 1, 3 and 4; f32 2e-5, bf16 2e-2); the three paged entry points on
``grid``, ``dense`` and ``dense`` + int8 against the JAX functions on the
same backend; engines on those backends giving the JAX engines' greedy
streams, step timings and (grid) grid accounting on a fixed trace; the
grid server's decision log and streams equal the JAX grid server's;
int8 refused on grid and flat as in the reference; the launcher's four
backend choices. The ``gpu``-marked tests hold the grid kernel against its
plain version and against the flat kernel on the card; JAX is imported by
the CPU tests only."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BS = 16
# a 128x spread (5 .. 640 tokens), a dead slot, lengths at whole blocks
# (640, 32, 16), a one-token row
LENS = [5, 640, 0, 32, 16, 130, 1]


def grid_case(H, Hkv, Dh, lens=LENS, seed=11, nbt=None):
    """Random pool rows for each live row's blocks; every table (``nbt``
    entries, default two past the longest row) padded with block 0, which
    row 1 owns (live data no padding entry may read)."""
    rng = np.random.default_rng(seed)
    need = [-(-n // BS) for n in lens]
    NB = sum(need) + 1
    NBT = max(need) + 2 if nbt is None else nbt
    assert NBT >= max(need)
    k_pool = rng.normal(0, 1, (NB, BS, Hkv, Dh)).astype(np.float32)
    v_pool = rng.normal(0, 1, (NB, BS, Hkv, Dh)).astype(np.float32)
    order = iter([0] + list(rng.permutation(np.arange(1, NB))))
    bt = np.zeros((len(lens), NBT), np.int32)
    for i in [1] + [i for i in range(len(lens)) if i != 1]:
        for j in range(need[i]):
            bt[i, j] = next(order)
    q = rng.normal(0, 1, (len(lens), H, Dh)).astype(np.float32)
    return q, k_pool, v_pool, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("H,Hkv,Dh", [(4, 4, 64), (6, 2, 128), (8, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_plain_matches_jax_grid_kernel(H, Hkv, Dh, dtype):
    """Every row (the dead slot's zeros included) == the Pallas grid
    kernel's, at G = 1, 3 and 4."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import paged_decode_attention
    q, kp, vp, bt, lens = grid_case(H, Hkv, Dh)
    assert (bt[:, -1] == 0).all() and bt[1, 0] == 0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = paged_decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, kp, vp)), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True)
    launches = dk.GRID_LAUNCHES
    got = dk.paged_decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
        torch.from_numpy(bt), torch.from_numpy(lens))
    assert dk.GRID_LAUNCHES == launches            # the CPU never launches
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert not got[2].any(), "dead slot row not zero"


# --------------------------------------------------------------------------
# The grid kernel's split plan and its split-then-merge arithmetic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sms", [8, 132, 400])
@pytest.mark.parametrize("Hkv", [1, 8])
@pytest.mark.parametrize("NBT", [1, 7, 208, 514, 70000])
@pytest.mark.parametrize("bs", [1, 16])
def test_grid_split_plan_covers_the_table_once(sms, Hkv, NBT, bs):
    """Splits [s*P, (s+1)*P) cover [0, NBT) once, none empty; a row as long
    as the table gives at most ~2 blocks per SM (Hkv * S), and P is the
    fewest entries that keep it there unless the minimum split (64 keys)
    sets P; S stays within the merge pass's MAX_SPLITS."""
    S, P = dk.grid_split_plan(Hkv, NBT, bs, sms)
    covered = np.zeros(NBT, np.int64)
    for s in range(S):
        lo, hi = s * P, min((s + 1) * P, NBT)
        assert lo < hi, "empty split"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 1 <= S <= dk.MAX_SPLITS
    assert P * bs >= dk.SPLIT_MIN_KEYS or P >= NBT
    want = min(-(-dk.SPLIT_BLOCKS_PER_SM * sms // Hkv), dk.MAX_SPLITS)
    if P > -(-dk.SPLIT_MIN_KEYS // bs):
        assert S <= want < -(-NBT // (P - 1))


def split_merge_emulation(q, kp, vp, bt, lens, S, P):
    """The grid kernel's arithmetic in torch: each split's output from the
    plain version over its table slice, its (m, l) from the scores, then
    the merge pass's formula over the splits that start below the
    length."""
    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    G = H // Hkv
    NBT = bt.shape[1]
    bt = torch.nn.functional.pad(bt, (0, S * P - NBT))     # block 0 pads
    ms, ls, accs = [], [], []
    for s in range(S):
        bt_s = bt[:, s * P:(s + 1) * P].contiguous()
        L_s = (lens - s * P * BS).clamp(0, P * BS).to(torch.int32)
        o_s = dk.paged_decode_attention_plain(q, kp, vp, bt_s, L_s)
        k_s = kp[bt_s.long()].reshape(B, P * BS, Hkv, Dh)
        sc = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, Hkv, G, Dh),
                          k_s) / math.sqrt(Dh)
        sc = torch.where(torch.arange(P * BS) < L_s[:, None, None, None],
                         sc, -math.inf)
        m = sc.amax(-1).reshape(B, H)
        l = torch.exp(sc - sc.amax(-1, keepdim=True)).sum(-1).reshape(B, H)
        ms.append(m)
        ls.append(torch.nan_to_num(l))
        accs.append(o_s * ls[-1][..., None])
    live = torch.stack([s * P * BS < lens for s in range(S)])      # [S, B]
    m = torch.stack(ms)
    mx = torch.where(live[..., None], m, -math.inf).amax(0)
    w = torch.where(live[..., None], torch.exp(m - mx), 0.0)       # [S,B,H]
    l = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    return acc / torch.where(l == 0, 1.0, l)[..., None]


@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("H,Hkv,Dh", [(4, 4, 64), (6, 2, 128)])
def test_grid_split_then_merge_matches_plain(sms, H, Hkv, Dh):
    """Split-then-merge as the grid kernel does it (plain version per split,
    the merge pass's formula) == ``paged_decode_attention_plain`` in f32 at
    1e-5, with lengths on either side of split edges and a dead slot."""
    nbt = 30
    lens, (S, P) = split_edge_case(Hkv, nbt, sms)
    lens[0] = nbt * BS                      # one row fills the table
    assert S > 1
    q, kp, vp, bt, lens = (torch.from_numpy(a) for a in grid_case(
        H, Hkv, Dh, lens=lens, nbt=nbt))
    got = split_merge_emulation(q, kp, vp, bt, lens, S, P)
    want = dk.paged_decode_attention_plain(q, kp, vp, bt, lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[2].any(), "dead slot row not zero"


# --------------------------------------------------------------------------
# The paged entry points on grid, dense and dense + int8
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """Reduced smollm-360m in both frameworks, the same weights."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    jcfg = jget("smollm-360m").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return types.SimpleNamespace(jax=jax, jcfg=jcfg, jmodel=jmodel,
                                 jparams=jparams, cfg=cfg,
                                 model=build_model(cfg), params=params)


NB = 24                     # block NB - 1 is the garbage block
POS = np.asarray([20, -1, 40], np.int32)        # decode slots, one dead
CTX = np.asarray([0, 17], np.int32)             # chunks of C = 16
CLEN = np.asarray([9, 5], np.int32)


def _tables(rng):
    blocks = iter(rng.permutation(NB - 1))
    bt_dec = np.full((3, 4), NB - 1, np.int32)
    for i, p in enumerate(POS):
        for j in range(-(-(p + 1) // BS)):
            bt_dec[i, j] = next(blocks)
    bt_ck = np.full((2, 4), NB - 1, np.int32)
    for i in range(2):
        for j in range(-(-(CTX[i] + CLEN[i]) // BS)):
            bt_ck[i, j] = next(blocks)
    return bt_dec, bt_ck


def _pools(models, kv, k, v):
    """(JAX pool, port pool) of one layer: f32 rows, or their int8
    quantization by the reference (the port's pool holds its values)."""
    from repro.models import attention as jattn
    jnp = models.jax.numpy
    if kv == "bf16":
        return (jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                tattn.KVCache(torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy())))
    (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(a)) for a in (k, v))
    jpool = jattn.QuantKVCache(kq, vq, ks, vs)
    return jpool, tattn.QuantKVCache(*(torch.from_numpy(np.array(a))
                                       for a in jpool))


@pytest.mark.parametrize("entry", ["decode", "chunk", "mixed"])
@pytest.mark.parametrize("backend,kv", [("grid", "bf16"), ("dense", "bf16"),
                                        ("dense", "int8")])
def test_paged_entry_points_match_jax(models, entry, backend, kv):
    """One layer's attention on each entry point == the JAX function on
    the same backend (grid: the Pallas kernels in interpret mode; the
    reference's mixed step runs its dense halves there), within 1e-4 on
    live rows; f32 pools' written rows within 1e-5."""
    from repro.models import attention as jattn
    from repro_torch.models.transformer import layer_params
    jnp = models.jax.numpy
    cfg = models.cfg
    rng = np.random.default_rng(3)
    shape = (NB, BS, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    bt_dec, bt_ck = _tables(rng)
    xd = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    xc = rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    jp = models.jax.tree.map(lambda a: a[0],
                             models.jparams["layers"]["attn"])
    tp = layer_params(models.params["layers"], 0)["attn"]
    jpool, tpool = _pools(models, kv, k, v)
    kw = dict(attn_backend=backend)
    J, T = jnp.asarray, torch.from_numpy
    if entry == "decode":
        jo, jpool = jattn.attention_decode_paged(
            jp, models.jcfg, J(xd), jpool, J(bt_dec), J(POS),
            attn_interpret=True, **kw)
        to, tpool = tattn.attention_decode_paged(
            tp, cfg, T(xd), tpool, T(bt_dec), T(POS), **kw)
        pairs = [(to.numpy()[POS >= 0], np.asarray(jo)[POS >= 0])]
    elif entry == "chunk":
        jo, jpool = jattn.attention_prefill_chunk_paged(
            jp, models.jcfg, J(xc), jpool, J(bt_ck), J(CTX), J(CLEN),
            attn_interpret=True, **kw)
        to, tpool = tattn.attention_prefill_chunk_paged(
            tp, cfg, T(xc), tpool, T(bt_ck), T(CTX), T(CLEN), **kw)
        pairs = [(to.numpy()[i, :n], np.asarray(jo)[i, :n])
                 for i, n in enumerate(CLEN)]
    else:
        jd, jc, jpool = jattn.attention_mixed_paged(
            jp, models.jcfg, J(xd), J(xc), jpool, J(bt_dec), J(bt_ck),
            J(POS), J(CTX), J(CLEN), attn_interpret=True, **kw)
        td, tc, tpool = tattn.attention_mixed_paged(
            tp, cfg, T(xd), T(xc), tpool, T(bt_dec), T(bt_ck), T(POS),
            T(CTX), T(CLEN), **kw)
        pairs = [(td.numpy()[POS >= 0], np.asarray(jd)[POS >= 0])] + [
            (tc.numpy()[i, :n], np.asarray(jc)[i, :n])
            for i, n in enumerate(CLEN)]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    if kv == "bf16":
        real = np.zeros((NB, BS), bool)
        for i, p in enumerate(POS):
            x = np.arange(p + 1)
            if entry != "chunk":
                real[bt_dec[i, x // BS], x % BS] = True
        for i in range(2):
            x = np.arange(CTX[i] + CLEN[i])
            if entry != "decode":
                real[bt_ck[i, x // BS], x % BS] = True
        for a, b in ((jpool.k, tpool.k), (jpool.v, tpool.v)):
            np.testing.assert_allclose(b.numpy()[real], np.asarray(a)[real],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Tq,S,offset,window", [(1, 40, 23, 0),
                                                (7, 30, 10, 0),
                                                (9, 24, 4, 6)])
def test_gqa_sdpa_matches_jax(Tq, S, offset, window):
    """The dense path's core: ``_gqa_sdpa`` under the reference's causal
    (and sliding-window) masks matches within 1e-5 (f32, G = 3)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import attention as jattn
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, Tq, 6, 64)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, S, 2, 64)).astype(np.float32)
            for _ in range(2))
    jmask = jattn._causal_mask(Tq, S, offset, window)
    mask = torch.from_numpy(np.array(jmask))
    want = jattn._gqa_sdpa(*(jnp.asarray(a) for a in (q, k, v)), jmask)
    got = tattn._gqa_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_int8_refused_on_grid_and_flat(models):
    """As in the reference: int8 pools need fused or dense."""
    pool = tattn.make_paged_pool(models.cfg, 2, BS, device="cpu",
                                 kv_dtype="int8")
    for backend in ("grid", "flat"):
        with pytest.raises(ValueError, match="'fused' or 'dense'"):
            tattn._check_kv_backend(pool, backend)
        with pytest.raises(ValueError, match="'fused' or 'dense'"):
            engine_mod.Engine(0, models.model, models.params,
                              attn_backend=backend, kv_dtype="int8")
    for backend in ("dense", "fused"):
        tattn._check_kv_backend(pool, backend)
    assert tattn.PAGED_BACKENDS == ("dense", "grid", "flat", "fused")
    assert tattn.resolve_paged_backend() == "fused"
    with pytest.raises(ValueError, match="unknown paged backend"):
        tattn.resolve_paged_backend("auto")


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
PROMPTS = (5, 23, 12)
NEW = 8
KW = dict(max_slots=3, max_seq=64, prefill_token_budget=8)


def _drive(eng, reqs, on_step=None, max_iters=200):
    for r in reqs:
        eng.submit(r)
    done = []
    for _ in range(max_iters):
        done += eng.step()
        if on_step is not None:
            on_step(eng)
        if len(done) == len(reqs):
            return
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("backend,kv", [("grid", "bf16"), ("dense", "bf16"),
                                        ("dense", "int8")])
def test_engine_streams_match_jax_engine(models, monkeypatch, backend, kv):
    """The trace of ``tests/test_fused_attention.py`` (prompts 5/23/12,
    chunk budget 8, 8 new tokens) on the torch engine and on the JAX
    engine with the same backend and KV dtype: identical greedy streams
    and first/finish steps; on grid also the same grid accounting after
    every step (``num_work`` 0, ``last_grid`` the reference's). Each
    torch step makes at most one d2h and two attention-bearing forwards,
    and every step with both a chunk and a decode makes two."""
    from repro.serving import engine as jengine_mod
    from repro.serving.request import ServeRequest as JaxRequest
    from repro_torch.serving.request import ServeRequest
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, models.cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    jeng = jengine_mod.Engine(0, models.jmodel, models.jparams,
                              attn_backend=backend, kv_dtype=kv, **KW)
    assert not jeng.fused_mixed
    jgrids = []
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drive(jeng, jreqs, lambda e: jgrids.append(dict(e.last_grid)))

    eng = engine_mod.Engine(0, models.model, models.params,
                            attn_backend=backend, kv_dtype=kv, **KW)
    assert not eng.fused_mixed and eng.attn_backend == backend
    works = []
    real_decode = eng._decode
    monkeypatch.setattr(eng, "_decode",
                        lambda num_work: works.append(num_work)
                        or real_decode(num_work))
    d2h = []
    real_d2h = engine_mod.d2h
    monkeypatch.setattr(engine_mod, "d2h",
                        lambda x: d2h.append(1) or real_d2h(x))
    grids, worst, both = [], [0, 0], [0]

    def per_step(e):
        grids.append(dict(e.last_grid))

    def counted(burst=1, _step=eng.step):
        d2h.clear()
        a0 = engine_mod.ATTN_CALLS
        out = _step(burst)
        n = engine_mod.ATTN_CALLS - a0
        worst[0] = max(worst[0], len(d2h))
        worst[1] = max(worst[1], n)
        both[0] += n == 2
        return out
    monkeypatch.setattr(eng, "step", counted)
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drive(eng, reqs, per_step)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    assert worst[0] <= 1 and worst[1] <= 2 and both[0] > 0
    assert works and set(works) == {0}
    if backend == "grid":
        assert grids == jgrids
        assert any(g.get("backend") == "grid" for g in grids)
    eng.check_drained()


def test_grid_accounting_16way_hetero_matches_jax(models):
    """tests/test_hotloop.py's 16-way heterogeneous batch on grid engines:
    after the first decode step ``last_grid`` (backend, flat_items,
    real_items, padded_items) equals the reference's, and the padded grid
    pays the heterogeneity tax the flat one avoids."""
    from repro.serving import engine as jengine_mod
    from repro.serving.request import ServeRequest as JaxRequest
    from repro_torch.serving.request import ServeRequest
    plens = [2, 2, 3, 4, 4, 6, 8, 8, 12, 16, 24, 32, 48, 64, 96, 120]
    kw = dict(max_slots=16, max_seq=256, block_size=16,
              prefill_token_budget=512, attn_backend="grid")
    grids = []
    for mod, req, eng in (
            (jengine_mod, JaxRequest, jengine_mod.Engine(
                0, models.jmodel, models.jparams, **kw)),
            (engine_mod, ServeRequest, engine_mod.Engine(
                0, models.model, models.params, **kw))):
        for i, p in enumerate(plens):
            eng.submit(req(i, np.full(p, 1, np.int32), 4))
        eng.step()
        grids.append(dict(eng.last_grid))
        for _ in range(40):                     # drain
            if not (eng.waiting or any(r is not None for r in eng.slots)):
                break
            eng.step()
    assert grids[0] == grids[1]
    g = grids[1]
    assert g["backend"] == "grid"
    assert g["real_items"] < g["padded_items"] / 3
    assert g["flat_items"] <= g["padded_items"] / 2


# --------------------------------------------------------------------------
# The cluster and the launcher
# --------------------------------------------------------------------------
QOE = np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])
# (prompt tokens, new tokens, arrival step): short prompts that decode
# across the 48-token stage boundary, one that starts above it, and a
# 70-token prompt that is still chunking when the plane looks
TRACE = [(20, 34, 0), (35, 20, 0), (12, 40, 1), (44, 10, 2), (28, 26, 3),
         (9, 30, 4), (70, 12, 5), (30, 24, 6)]
SKW = dict(max_slots=3, max_seq=128, prefill_token_budget=16)


def test_grid_server_decision_log_matches_jax_grid_server(models):
    """The port's MILSServer on grid engines and the JAX one on grid
    engines (Pallas in interpret mode), preemption and the host tier off:
    identical decision logs, migrations > 0, greedy streams and step
    timings; every engine drains clean."""
    from repro.core.partition import PipelinePlan as JPlan
    from repro.core.partition import Stage as JStage
    from repro.core.qoe import QoEModel as JQoE
    from repro.serving.request import ServeRequest as JaxRequest
    from repro.serving.server import MILSServer as JServer
    from repro.serving.server import ServerConfig as JConfig
    from repro_torch.core.partition import PipelinePlan, Stage
    from repro_torch.core.qoe import QoEModel
    from repro_torch.serving.request import ServeRequest
    from repro_torch.serving.server import MILSServer, ServerConfig
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, models.cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in TRACE]

    def run(server, plan, stage, qoe, config, req, model, params):
        srv = server(model, params,
                     plan([stage(0.0, 48.0, 2),
                           stage(48.0, float("inf"), 2)], 0.0),
                     qoe(QOE), config(seed=0, preemption=False,
                                      host_kv_budget=0),
                     attn_backend="grid", **SKW)
        reqs = [req(i, p.copy(), new)
                for i, (p, (_, new, _)) in enumerate(zip(prompts, TRACE))]
        for r, (_, _, at) in zip(reqs, TRACE):
            srv.submit_at(r, at)
        srv.run(max_steps=400)
        return srv, reqs

    jsrv, jreqs = run(JServer, JPlan, JStage, JQoE, JConfig, JaxRequest,
                      models.jmodel, models.jparams)
    srv, reqs = run(MILSServer, PipelinePlan, Stage, QoEModel, ServerConfig,
                    ServeRequest, models.model, models.params)
    assert all(e.attn_backend == "grid" for e in srv.engines)
    assert srv.plane.decisions == jsrv.plane.decisions
    assert srv.migrations == jsrv.migrations > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]


@pytest.mark.parametrize("backend", ["dense", "grid", "flat", "fused"])
def test_launcher_takes_the_four_backends(backend):
    args = serve.parse_args(["--attn-backend", backend])
    assert args.attn_backend == backend
    with pytest.raises(SystemExit):
        serve.parse_args(["--attn-backend", "auto"])


@pytest.mark.parametrize("argv", [["--attn-backend", "grid"],
                                  ["--attn-backend", "dense",
                                   "--kv-dtype", "int8"]])
def test_launcher_runs_grid_and_dense_int8_on_the_cpu(capsys, argv):
    serve.main(["--device", "cpu", "--engines", "2", "--requests", "4",
                "--max-seq", "96", *argv])
    out = capsys.readouterr().out
    assert "summary:" in out and "stage bounds:" in out


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, decided here (never at import or collection time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def split_edge_case(Hkv, nbt, sms, long_row=None):
    """Lengths on either side of the grid plan's split edges for a table of
    ``nbt`` entries on ``sms`` SMs (row 2 a dead slot), led by
    ``long_row`` tokens if given; the plan's ``(S, P)``."""
    S, P = dk.grid_split_plan(Hkv, nbt, BS, sms)
    edge = P * BS
    lens = [edge + 1, edge, 0, edge - 1, 1, min(2 * edge + 1, nbt * BS),
            min(2 * edge - 1, nbt * BS)]
    if long_row is not None:          # the dead slot moves to row 3
        lens = [long_row] + lens
    return lens, (S, P)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
@pytest.mark.parametrize("case", ["llama", "g10", "split_edges",
                                  "long_8192", "wide_table"])
def test_cuda_grid_decode_matches_plain_and_flat(cuda, dtype, tol, case):
    """The built grid kernel == its plain version on the card and agrees
    with the flat kernel on the same rows, at llama3.2-3b heads (G 3,
    Dh 128) and at G 10 / Dh 64 (two rows a thread); at lengths on either
    side of the split plan's edges; with one row of 8192 tokens beside
    short rows and a dead slot; and with a table far wider than the
    longest row. The dead slot's row is zero; a second call gives the same
    output (the kernel's arrival counts are left at 0)."""
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    H, Hkv, Dh = (20, 2, 64) if case == "g10" else (24, 8, 128)
    nbt, lens = None, LENS
    if case == "split_edges":
        nbt = 40
        lens, _ = split_edge_case(Hkv, nbt, sms)
    elif case == "long_8192":
        nbt = 8192 // BS + 2
        lens, _ = split_edge_case(Hkv, nbt, sms, long_row=8192)
    elif case == "wide_table":
        nbt = 600
    q, kp, vp, bt, lens = grid_case(H, Hkv, Dh, lens=lens, nbt=nbt)
    dead = list(lens).index(0)
    floats = [torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(cuda) for a in (bt, lens)]
    launches = dk.GRID_LAUNCHES
    out = dk.paged_decode_attention(*floats, *ints)
    torch.cuda.synchronize()
    assert dk.GRID_LAUNCHES == launches + 1
    plain = dk.paged_decode_attention_plain(*floats, *ints)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
    flat = dk.paged_decode_attention_flat(*floats, *ints)
    torch.testing.assert_close(out.float(), flat.float(), atol=tol,
                               rtol=tol)
    # the arrival counts reset themselves: a second call merges the same
    assert torch.equal(dk.paged_decode_attention(*floats, *ints), out)
    assert not out[dead].float().abs().max().item()
    assert math.isfinite(out.float().abs().max().item())
