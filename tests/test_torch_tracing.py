"""The program's spans (``utils/profiling.py:span``, ``spanned``), its
one launch count (``kernels/_launch.py:LAUNCHES``), its count of the
decimated family's products (``ops/fwt.py:PRODUCTS``: 12 a packet tree
and 24 a reconstruction at L6) and the sharded tier's collective counts
(``parallel.sharded.COLLECTIVES``, ``COLLECTIVE_BYTES``).

With no profiler running a span is the one shared null context and
``record_function`` is never called.  Under ``torch.profiler`` the spans
of ``modwt_denoise``, ``modwt2_denoise``, ``modwt3_denoise``,
``wpt_denoise``, ``cwt`` and a ``StreamingMODWT.update`` nest as the
stages run: the threshold and the shrink inside each MODWT denoise (one
pair of helpers for 1D, 2D and 3D), the packet tree, the basis search,
the threshold and the mixed-level synthesis inside the packet denoise,
whose answers stay bitwise those of its former in-line threshold, the
host-to-device copies of the axes inside the CWT, the buffer's stages
inside the update, and a launch inside the transform that makes it.  In
a spawned gloo world of 4 ranks, a signal-sharded MODWT forward spans its
one fetch of the halo and that fetch its one ring hop, of rows × 217
float32 samples at Daubechies 4 L5.  On the card (``cuda``), a launch's
span holds its ``cudaLaunchKernel``, ``LAUNCHES`` counts eager and
served launches alike, a default 2D denoise launches the 2D forward,
the median and the 2D inverse once each, and a packet denoise makes its
36 products in IEEE float32 and one launch, the median's.
"""
import importlib
import json
import multiprocessing
import os
import tempfile
import traceback

import numpy as np
import pytest
import torch

import jwave_pro_tpu_torch as jt
from jwave_pro_tpu_torch import streaming as st
from jwave_pro_tpu_torch.kernels._launch import LAUNCHES, op_taps

profiling = importlib.import_module("jwave_pro_tpu_torch.utils.profiling")
fwt_ops = importlib.import_module("jwave_pro_tpu_torch.ops.fwt")
denoise_ops = importlib.import_module("jwave_pro_tpu_torch.ops.denoise")

DB4 = jt.wavelet("Daubechies 4")
SYM8 = jt.wavelet("Symlet 8")
ACTS = [torch.profiler.ProfilerActivity.CPU]


def _signal(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _stream(seed=0):
    """A CPU stream past its halo, and its next chunk (host NumPy)."""
    s = st.StreamingMODWT(DB4, st.StreamingConfig(1024, 3, device="cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(3):
        s.update(rng.standard_normal(128).astype(np.float32))
    return s, rng.standard_normal(128).astype(np.float32)


def _calls():
    """The calls the spans are checked on, as thunks."""
    x = _signal(2, 1000, seed=1)
    image = _signal(2, 40, 48, seed=7)
    volume = _signal(2, 6, 10, 12, seed=8)
    scales = jt.generate_log_scales(1.0, 32.0, 6)
    stream, chunk = _stream()
    packets = _signal(3, 4096, seed=11)
    return {"modwt_denoise": lambda: jt.modwt_denoise(x, DB4, 3),
            "wpt_denoise": lambda: jt.wpt_denoise(packets, SYM8, 6,
                                                  per_sample=True),
            "modwt2_denoise": lambda: jt.modwt2_denoise(image, DB4, 2),
            "modwt3_denoise": lambda: jt.modwt3_denoise(volume, DB4, 2),
            "cwt": lambda: jt.cwt(x, scales),
            "update": lambda: stream.update(chunk)}


def _profiled(fn, activities=ACTS):
    """The ``user_annotation`` and runtime events of ``fn`` run under a
    profiler, as (name, category, start, end), by start."""
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["cat"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "user_annotation", "cuda_runtime", "cuda_driver")),
                  key=lambda e: (e[2], -e[3]))


def _parents(events):
    """Each ``jwave.*`` span's innermost enclosing ``jwave.*`` span (None
    at the top), as a list of (name, parent) in start order."""
    out, stack = [], []
    for name, cat, s, e in events:
        if cat != "user_annotation" or not name.startswith("jwave."):
            continue
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, e))
    return out


# -- with no profiler ---------------------------------------------------------

def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("jwave.a"), profiling.span("jwave.b")
    assert a is b is profiling._NULL
    with a as got:
        assert got is None


@pytest.mark.parametrize("call", ["modwt_denoise", "modwt2_denoise",
                                  "modwt3_denoise", "cwt", "update",
                                  "wpt_denoise"])
def test_no_profiler_never_records(monkeypatch, call):
    """Every span site of the call is guarded: with ``record_function``
    made to raise, the call runs and gives the answer it gives with the
    real one."""
    want = _calls()[call]()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got = _calls()[call]()
    got, want = (getattr(v, "coefficients", v) for v in (got, want))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spanned_keeps_the_function():
    @profiling.spanned("jwave.test")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f(1, b=3) == 4 and f.__name__ == "f" and f.__doc__ == "doc"
    assert jt.modwt.__name__ == "modwt" and "level" in jt.modwt.__doc__


# -- under a CPU profiler -----------------------------------------------------

NESTING = {
    "modwt_denoise": [("jwave.modwt_denoise", None),
                      ("jwave.modwt", "jwave.modwt_denoise"),
                      ("jwave.denoise.threshold", "jwave.modwt_denoise"),
                      ("jwave.denoise.shrink", "jwave.modwt_denoise"),
                      ("jwave.imodwt", "jwave.modwt_denoise")],
    "modwt2_denoise": [("jwave.modwt2_denoise", None),
                       ("jwave.denoise.threshold", "jwave.modwt2_denoise"),
                       ("jwave.denoise.shrink", "jwave.modwt2_denoise")],
    "modwt3_denoise": [("jwave.modwt3_denoise", None),
                       ("jwave.denoise.threshold", "jwave.modwt3_denoise"),
                       ("jwave.denoise.shrink", "jwave.modwt3_denoise")],
    "wpt_denoise": [("jwave.wpt_denoise", None),
                    ("jwave.wpt.tree", "jwave.wpt_denoise"),
                    ("jwave.wpt.basis", "jwave.wpt_denoise"),
                    ("jwave.denoise.threshold", "jwave.wpt_denoise"),
                    ("jwave.wpt.reconstruct", "jwave.wpt_denoise")],
    "cwt": [("jwave.cwt", None), ("jwave.cwt.axes", "jwave.cwt"),
            ("jwave.cwt.axes", "jwave.cwt")],
    "update": [("jwave.stream.update", None),
               ("jwave.stream.chunk", "jwave.stream.update"),
               ("jwave.stream.append", "jwave.stream.update"),
               ("jwave.stream.window", "jwave.stream.update"),
               ("jwave.stream.tail", "jwave.stream.update"),
               ("jwave.modwt", "jwave.stream.tail"),
               ("jwave.stream.splice", "jwave.stream.update")],
}


@pytest.mark.parametrize("call", sorted(NESTING))
def test_spans_nest_as_the_stages_run(call):
    fn = _calls()[call]
    fn()                                  # multipliers built and cached
    got = [p for p in _parents(_profiled(fn))
           if p[0] != "jwave.cwt.multipliers"]
    assert got == NESTING[call]


def test_the_fused_denoise_spans_its_threshold():
    x = _signal(2, 1000, seed=2)
    got = _parents(_profiled(lambda: jt.modwt_denoise(x, DB4, 3,
                                                      method="fused")))
    assert got[:3] == [("jwave.modwt_denoise", None),
                       ("jwave.modwt", "jwave.modwt_denoise"),
                       ("jwave.denoise.threshold", "jwave.modwt_denoise")]
    # a given threshold takes no estimate
    names = [n for n, _ in _parents(_profiled(
        lambda: jt.modwt_denoise(x, DB4, 3, threshold=0.5)))]
    assert "jwave.denoise.threshold" not in names
    assert "jwave.denoise.shrink" in names


def test_a_given_2d_threshold_takes_no_estimate():
    x = _signal(2, 40, 48, seed=9)
    names = [n for n, _ in _parents(_profiled(
        lambda: jt.modwt2_denoise(x, DB4, 2, threshold=0.5)))]
    assert names == ["jwave.modwt2_denoise", "jwave.denoise.shrink"]


@pytest.mark.parametrize("stage,want", [("tree", 12), ("reconstruct", 24),
                                        ("denoise", 36)])
def test_products_count_each_filter_bank_product(stage, want):
    """At L6 with every packet width a multiple of 256, a tree level is
    one analysis step (2 products) and a reconstruction level one
    synthesis step (4): 12 and 24 a call, 36 for the denoise, all off the
    card (``"cpu"``)."""
    x = _signal(2, 16384, seed=12)
    masks, _, tree = jt.best_basis(x, SYM8, 6, "sure", per_sample=True)
    flat = jt.basis_coefficients(tree, masks)
    call = {"tree": lambda: jt.wpt_tree(x, SYM8, 6),
            "reconstruct": lambda: jt.basis_reconstruct(flat, masks, SYM8),
            "denoise": lambda: jt.wpt_denoise(x, SYM8, 6,
                                              per_sample=True)}[stage]
    before = fwt_ops.PRODUCTS.copy()
    call()
    ran = {k: fwt_ops.PRODUCTS[k] - before[k] for k in fwt_ops.PRODUCTS
           if fwt_ops.PRODUCTS[k] != before[k]}
    assert ran == {"cpu": want}


def _inline_wpt(x, wavelet, level, per_sample):
    """What ``wpt_denoise`` ran with its default threshold before that
    threshold went through ``_rule_threshold``: ``universal_threshold``
    called in line."""
    n = x.shape[-1]
    masks, _, tree = jt.best_basis(x, wavelet, level, "sure",
                                   per_sample=per_sample)
    flat = jt.basis_coefficients(tree, masks)
    threshold = denoise_ops.universal_threshold(tree[1][..., n // 2:],
                                                n)[..., None]
    shrunk = jt.soft_threshold(flat, threshold)
    pos = torch.arange(n)
    keep = torch.zeros((n,), dtype=torch.bool)
    for lv, m in enumerate(masks):
        keep = keep | (m[..., 0:1] & (pos < (n >> lv)))
    return jt.basis_reconstruct(torch.where(keep, flat, shrunk), masks,
                                wavelet)


@pytest.mark.parametrize("per_sample", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_wpt_threshold_answers_bitwise_as_before(per_sample, dtype):
    x = _signal(3, 4096, seed=13).to(dtype)
    got = jt.wpt_denoise(x, SYM8, 6, per_sample=per_sample)
    want = _inline_wpt(x, SYM8, 6, per_sample)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_multipliers_span_only_when_built():
    """The first call at a new grid builds the half-spectrum multipliers
    and their device copy; a second with the same scales builds nothing."""
    x = _signal(3, 777, seed=3)
    scales = jt.generate_log_scales(1.37, 41.3, 7)
    first = [n for n, _ in _parents(_profiled(lambda: jt.cwt(x, scales)))]
    again = [n for n, _ in _parents(_profiled(lambda: jt.cwt(x, scales)))]
    assert first.count("jwave.cwt.multipliers") == 3   # host A, B on device
    assert "jwave.cwt.multipliers" not in again
    assert again.count("jwave.cwt.axes") == 2


def test_a_refused_launch_is_spanned_and_not_counted():
    """The operator's registered CPU kernel is the counted launch: a CPU
    tensor raises inside its span, and the launch does not count."""
    g, h = op_taps(DB4)
    before = LAUNCHES["modwt_fwd"]

    def call():
        with pytest.raises(ValueError, match="CUDA tensor"):
            torch.ops.jwave.modwt_fwd(_signal(2, 64), g, h, 2)

    names = [n for n, _ in _parents(_profiled(call))]
    assert names == ["jwave.launch.modwt_fwd"]
    assert LAUNCHES["modwt_fwd"] == before


def test_no_span_while_torch_traces():
    """Under a running profiler a span records, but not while torch
    traces an export: its graph then keeps no profiler operator, and it
    serves what the export made without a profiler serves."""
    seen = []

    def fn(v):
        seen.append(profiling.span("jwave.test") is profiling._NULL)
        return jt.modwt(v, DB4, 2, method="direct")

    x = _signal(2, 256, seed=4)
    plain = jt.export_pipeline(fn, x)
    with torch.profiler.profile(activities=ACTS):
        assert profiling.span("jwave.test") is not profiling._NULL
        under = jt.export_pipeline(fn, x)
    assert seen and all(seen)
    targets = [str(n.target) for n in jt.load_pipeline(under).graph.nodes]
    assert not [t for t in targets if "record_function" in t]
    torch.testing.assert_close(jt.load_pipeline(under)(x),
                               jt.load_pipeline(plain)(x), rtol=0, atol=0)


# -- a signal-sharded forward in a gloo world of 4 ranks ----------------------

RANKS, SHARDED_CALLS, SHARDED_SHAPE = 4, 3, (3, 4 * 1024)
SHARDED_NESTING = [("jwave.sharded.modwt", None),
                   ("jwave.sharded.halo", "jwave.sharded.modwt"),
                   ("jwave.sharded.hop", "jwave.sharded.halo")]


def _sharded_rank(rank: int, path: str) -> None:
    """One rank: the forward's spans under a profiler, its hops and bytes
    counted, and its answer with ``record_function`` made to raise."""
    import torch.distributed as dist

    from jwave_pro_tpu_torch import parallel as par
    from jwave_pro_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    out = {}
    try:
        par.init_distributed(f"file://{path}/store", RANKS, rank,
                             device_type="cpu", timeout=60)
        mesh = par.make_mesh({"signal": RANKS}, device_type="cpu")
        x = _signal(*SHARDED_SHAPE, seed=7)

        def calls():
            return [par.modwt_sharded(x, DB4, 5, mesh).to_local()
                    for _ in range(SHARDED_CALLS)]

        want = calls()
        sharded.reset_collectives()
        events = _profiled(calls)
        out["parents"] = np.array(json.dumps(_parents(events)))
        out["hops"] = np.array(sharded.COLLECTIVES["hop"])
        out["bytes"] = np.array(sharded.COLLECTIVE_BYTES["hop"])

        def refuse(name):
            raise AssertionError(f"record_function({name!r}) with no "
                                 f"profiler")

        torch.profiler.record_function = refuse
        torch.autograd.profiler.record_function = refuse
        got = calls()
        out["unprofiled_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(got, want)))
        dist.destroy_process_group()
    except Exception:
        out["error"] = np.array(traceback.format_exc())
    np.savez(f"{path}/rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank, args=(r, str(path)))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive and [p.exitcode for p in procs] == [0] * RANKS
    ranks = []
    for r in range(RANKS):
        with np.load(path / f"rank{r}.npz") as saved:
            got = dict(saved)
        assert "error" not in got, str(got.get("error"))
        ranks.append(got)
    return ranks


@pytest.mark.parametrize("rank", range(RANKS))
def test_sharded_forward_spans_one_fetch_and_one_hop(sharded_ranks, rank):
    got = [tuple(p) for p in json.loads(str(sharded_ranks[rank]["parents"]))]
    assert got == SHARDED_NESTING * SHARDED_CALLS


@pytest.mark.parametrize("rank", range(RANKS))
def test_sharded_hop_counts_its_bytes(sharded_ranks, rank):
    """One hop a call, of the halo's rows × 217 float32 samples (the
    Daubechies 4 L5 halo, shorter than the 1024-sample shard)."""
    r = sharded_ranks[rank]
    rows = SHARDED_SHAPE[0]
    assert int(r["hops"]) == SHARDED_CALLS
    assert int(r["bytes"]) == SHARDED_CALLS * rows * 217 * 4


@pytest.mark.parametrize("rank", range(RANKS))
def test_sharded_spans_never_record_without_a_profiler(sharded_ranks, rank):
    assert bool(sharded_ranks[rank]["unprofiled_equal"])


# -- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_span_holds_its_kernel_launch(dev):
    x = _signal(4, 8192, seed=5).to(dev)
    jt.modwt(x, DB4, 3)
    torch.cuda.synchronize()
    events = _profiled(lambda: (jt.modwt(x, DB4, 3),
                                torch.cuda.synchronize()),
                       ACTS + [torch.profiler.ProfilerActivity.CUDA])
    spans = [(s, e) for n, _, s, e in events
             if n == "jwave.launch.modwt_fwd"]
    launches = [s for n, c, s, _ in events
                if c == "cuda_runtime" and n.startswith("cudaLaunch")]
    assert len(spans) == 1 and launches
    lo, hi = spans[0]
    assert [s for s in launches if lo <= s < hi]


@pytest.mark.cuda
def test_launches_count_eager_and_served_alike(dev):
    x = _signal(8, 8192, seed=6).to(dev)
    fn = lambda v: jt.modwt_denoise(v, DB4, 5, threshold=0.8)  # noqa: E731
    served = jt.load_pipeline(jt.export_pipeline(fn, x,
                                                 batch_polymorphic=True))
    for call in (lambda: fn(x), lambda: served(x), lambda: served(x[:3])):
        before = LAUNCHES.copy()
        call()
        torch.cuda.synchronize()
        ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
               if LAUNCHES[k] != before[k]}
        assert ran == {"modwt_fwd": 1, "modwt_inv_shrink": 1}


@pytest.mark.cuda
def test_default_2d_denoise_launches_each_2d_kernel_once(dev):
    """The default 2D denoise on the card: the 2D forward, the threshold's
    median on |HH1| and the 2D inverse that shrinks the bands as it loads
    them, one launch each a call, inside the denoise's span with its
    threshold; no shrink span, since no plain shrink runs."""
    x = _signal(4, 512, 512, seed=10).to(dev)
    jt.modwt2_denoise(x, DB4, 3)
    torch.cuda.synchronize()
    for _ in range(2):
        before = LAUNCHES.copy()
        jt.modwt2_denoise(x, DB4, 3)
        torch.cuda.synchronize()
        ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
               if LAUNCHES[k] != before[k]}
        assert ran == {"modwt2_fwd": 1, "median": 1, "modwt2_inv_shrink": 1}
    got = _parents(_profiled(lambda: (jt.modwt2_denoise(x, DB4, 3),
                                      torch.cuda.synchronize()),
                             ACTS + [torch.profiler.ProfilerActivity.CUDA]))
    assert got == [("jwave.modwt2_denoise", None),
                   ("jwave.launch.modwt2_fwd", "jwave.modwt2_denoise"),
                   ("jwave.denoise.threshold", "jwave.modwt2_denoise"),
                   ("jwave.launch.median", "jwave.denoise.threshold"),
                   ("jwave.launch.modwt2_inv_shrink",
                    "jwave.modwt2_denoise")]


@pytest.mark.cuda
def test_wpt_denoise_products_are_ieee_on_the_card(dev):
    x = _signal(4, 16384, seed=14).to(dev)
    jt.wpt_denoise(x, SYM8, 6, per_sample=True)
    torch.cuda.synchronize()
    products, launches = fwt_ops.PRODUCTS.copy(), LAUNCHES.copy()
    jt.wpt_denoise(x, SYM8, 6, per_sample=True)
    torch.cuda.synchronize()
    assert {k: fwt_ops.PRODUCTS[k] - products[k] for k in fwt_ops.PRODUCTS
            if fwt_ops.PRODUCTS[k] != products[k]} == {"ieee": 36}
    assert {k: LAUNCHES[k] - launches[k] for k in LAUNCHES
            if LAUNCHES[k] != launches[k]} == {"median": 1}
