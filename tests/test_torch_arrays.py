"""The port's array path against the JAX package, on the CPU.

Each workload is written once, as a function of a package's frame and IR
modules, and runs through both packages on the same numpy inputs under
kernelize "off", "always" and "auto": ``weldnp`` map chains (a float
chain, an integer chain with ``/`` and ``%`` on negative values, ``min``
and ``max`` over NaN, a select, an empty column), Black-Scholes as a
price vector and as a sum, ``dot`` as 1-D, matvec and matmul, and
``weldflow``'s logistic-regression scoring (the paper's Fig. 5d graph).
Values agree to: integers exactly, f64 to rtol 1e-12 (libm and summation
order differ between the backends by a few ulps).  Under "always" the
array routes are taken the same number of times in both packages.  The
JAX package runs its kernel routes through ``kernel_impl="ref"``: its
map-chain interpret mode refuses a body that captures a scalar (logreg's
bias), and its kernels are held in interpret mode one by one in
``test_torch_kernels.py``.  The sessions ``native`` and ``weld`` are held
against the reference's; the ``xla`` session (``torch.compile``) takes
about 33 s to compile on a CPU, so only ``chip_smoke.py`` runs it.

The second half holds the map-chain generator's semantics: each body is
emitted as C, compiled as host C++ (``-DWELD_MC_HOST``) with the
system's ``g++ -O0 -ffp-contract=off``, called through ``ctypes`` on
numpy columns and compared with the generic emitter's result on the same
columns, for every node and operator the generator covers.  Bodies of
``+ - * /``, ``%``, ``min``/``max``, ``neg``/``abs``/``floor``, casts,
selects and literals must match bitwise (IEEE arithmetic, no
contraction on either side); bodies with libm calls are held to f64
rtol 1e-12 and f32 rtol 1e-5, because glibc's and PyTorch's (SLEEF)
transcendentals round differently in the last bits — and so is
``sqrt``, which PyTorch's vectorized CPU kernel does not round
correctly (on the card both sides use the IEEE ``sqrt``); integers and
bools exactly.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import ir as r_ir, lazy as r_lazy, macros as r_M
from repro.core import wtypes as r_wt
from repro.frames import weldflow as r_weldflow, weldnp as r_weldnp
from repro_torch.core import ir as t_ir, lazy as t_lazy, macros as t_M
from repro_torch.core import wtypes as t_wt
from repro_torch.core import kernelplan as t_kernelplan
from repro_torch.core.kernelplan import plan_kernels
from repro_torch.frames import weldflow as t_weldflow, weldnp as t_weldnp
from repro_torch.kernels import map_chain as t_mc
from torch_mapchain_cases import (CARD_ONLY, GEN_CASES, column, gen_lambda,
                                  plain_env)

REF = SimpleNamespace(ir=r_ir, wt=r_wt, M=r_M, lazy=r_lazy, weldnp=r_weldnp,
                      weldflow=r_weldflow, impl="ref")
PORT = SimpleNamespace(ir=t_ir, wt=t_wt, M=t_M, lazy=t_lazy, weldnp=t_weldnp,
                       weldflow=t_weldflow, impl=None)

MODES = ("off", "always", "auto")
SPECS = ("map_elementwise", "matmul", "matvec", "filter_reduce_sum")
RTOL_F64 = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    repro_torch.set_default_device("cpu")
    yield
    repro_torch.set_default_device("cuda")


def _eval(pkg, obj, kz, stats):
    return pkg.lazy.Evaluate(obj, kernelize=kz, kernel_impl=pkg.impl,
                             collect_stats=stats).value


# ---------------------------------------------------------------------------
# workloads, written once (numpy inputs from a seed)
# ---------------------------------------------------------------------------


def map_exp(pkg, kz, stats):
    x = np.random.RandomState(0).randn(4096)
    wnp = pkg.weldnp
    return _eval(pkg, (wnp.exp(wnp.array(x) * 2.0) + 1.0).obj, kz, stats)


def map_empty(pkg, kz, stats):
    wnp = pkg.weldnp
    return _eval(pkg, (wnp.exp(wnp.array(np.zeros(0)) * 2.0) + 1.0).obj,
                 kz, stats)


def map_int_chain(pkg, kz, stats):
    """((x / 3) % -4) * 7 - x % 5 on int64 values of both signs: C
    truncation for / and the dividend's sign for %."""
    x = np.random.RandomState(1).randint(-1000, 1000, 4097).astype(np.int64)
    ir, wt = pkg.ir, pkg.wt
    o = pkg.lazy.NewWeldObject(x, None)

    def lit(c):
        return ir.Literal(c, wt.I64)

    def body(v):
        r = ir.BinOp("%", ir.BinOp("/", v, lit(3)), lit(-4))
        return ir.BinOp("-", ir.BinOp("*", r, lit(7)),
                        ir.BinOp("%", v, lit(5)))

    expr = pkg.M.map_(ir.Ident(o.obj_id, o.weld_type()), body)
    return _eval(pkg, pkg.lazy.NewWeldObject([o], expr), kz, stats)


def map_minmax_nan(pkg, kz, stats):
    rng = np.random.RandomState(2)
    x = rng.randn(3000)
    x[rng.rand(3000) < 0.1] = np.nan
    wnp = pkg.weldnp
    y = wnp.maximum(wnp.minimum(wnp.array(x) * 1.5, 0.5), -0.25)
    return _eval(pkg, y.obj, kz, stats)


def map_select(pkg, kz, stats):
    rng = np.random.RandomState(3)
    x, y = rng.randn(2500), rng.randn(2500)
    wnp = pkg.weldnp
    a, b = wnp.array(x), wnp.array(y)
    return _eval(pkg, wnp.where(a > 0.1, a * 2.0, b - 1.0).obj, kz, stats)


def _bs_price(pkg):
    """The Black-Scholes call price of benchmarks/workloads.py."""
    rng = np.random.RandomState(1)
    n = 3000
    wnp = pkg.weldnp
    s = wnp.array(rng.uniform(10, 200, n))
    k = wnp.array(rng.uniform(10, 200, n))
    t = wnp.array(rng.uniform(0.1, 2.0, n))
    rf, vol, inv_sqrt2 = 0.02, 0.30, 1.0 / np.sqrt(2.0)

    def cnd(x):
        return (wnp.erf(x * inv_sqrt2) + 1.0) * 0.5

    sqrt_t = wnp.sqrt(t)
    sig_t = sqrt_t * vol
    d1 = (wnp.log(s / k) + t * (rf + 0.5 * vol * vol)) / sig_t
    d2 = d1 - sig_t
    return s * cnd(d1) - k * wnp.exp(t * (-rf)) * cnd(d2)


def bs_vector(pkg, kz, stats):
    return _eval(pkg, _bs_price(pkg).obj, kz, stats)


def bs_sum(pkg, kz, stats):
    return _eval(pkg, _bs_price(pkg).sum().obj, kz, stats)


def dot_1d(pkg, kz, stats):
    rng = np.random.RandomState(4)
    a, b = pkg.weldnp.array(rng.randn(4000)), pkg.weldnp.array(rng.randn(4000))
    return _eval(pkg, a.dot(b).obj, kz, stats)


def matvec(pkg, kz, stats):
    rng = np.random.RandomState(5)
    m = pkg.weldnp.array(rng.randn(300, 64))
    v = pkg.weldnp.array(rng.randn(64))
    return _eval(pkg, m.dot(v).obj, kz, stats)


def matmul(pkg, kz, stats):
    rng = np.random.RandomState(6)
    a = pkg.weldnp.array(rng.randn(130, 64))
    b = pkg.weldnp.array(rng.randn(64, 70))
    return _eval(pkg, a.dot(b).obj, kz, stats)


def _logreg_data(n=4096, d=64, seed=7):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d), rng.rand(d)


def _logreg_graph(pkg, m, w):
    """Fig. 5d: mean(log(sigmoid(X @ w + b))) as bench_logreg builds it."""
    wf = pkg.weldflow
    x = wf.placeholder()
    logits = wf.matvec(x, wf.constant(w)) + 0.25
    return wf.reduce_mean(wf.log(wf.sigmoid(logits))), {x: m}


def logreg(pkg, kz, stats):
    loss, feed = _logreg_graph(pkg, *_logreg_data())
    obj, merged = pkg.weldflow.transform_graph(loss, feed)
    assert merged == 5
    return _eval(pkg, obj, kz, stats)


WORKLOADS = {
    "map_exp": map_exp, "map_empty": map_empty,
    "map_int_chain": map_int_chain, "map_minmax_nan": map_minmax_nan,
    "map_select": map_select, "bs_vector": bs_vector, "bs_sum": bs_sum,
    "dot_1d": dot_1d, "matvec": matvec, "matmul": matmul, "logreg": logreg,
}

#: the kernel routes each workload takes under "always" (in both packages)
ROUTES = {
    "map_exp": {"map_elementwise": 1},
    "map_empty": {"map_elementwise": 1},
    "map_int_chain": {"map_elementwise": 1},
    "map_minmax_nan": {"map_elementwise": 1},
    "map_select": {"map_elementwise": 1},
    "bs_vector": {"map_elementwise": 1},
    "bs_sum": {"filter_reduce_sum": 1},
    "dot_1d": {},
    "matvec": {"matvec": 1},
    "matmul": {"matmul": 1},
    "logreg": {"matvec": 2, "map_elementwise": 1, "filter_reduce_sum": 1},
}


#: products: a sum of k terms taken in another order, so an element that
#: cancels to near zero has no relative bound; these are held to rtol
#: 1e-12 of the result's largest magnitude instead
LINALG = {"dot_1d", "matvec", "matmul"}


def _same(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        atol = (RTOL_F64 * max(float(np.abs(want).max()), 1.0)
                if name in LINALG else 0)
        np.testing.assert_allclose(got, want, rtol=RTOL_F64, atol=atol,
                                   equal_nan=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_matches_reference(name, mode):
    r_stats, t_stats = {}, {}
    want = WORKLOADS[name](REF, mode, r_stats)
    got = WORKLOADS[name](PORT, mode, t_stats)
    _same(got, want, name)
    if mode == "always":
        for spec in SPECS:
            key = f"kernelize.{spec}"
            assert t_stats.get(key, 0) == r_stats.get(key, 0), key
            assert t_stats.get(key, 0) == ROUTES[name].get(spec, 0), key


@pytest.mark.parametrize("session", ["native", "weld"])
def test_weldflow_sessions_match_reference(session):
    m, w = _logreg_data()
    want = REF.weldflow.Session(session).run(*_logreg_graph(REF, m, w))
    got = PORT.weldflow.Session(session).run(*_logreg_graph(PORT, m, w))
    assert np.asarray(got).shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_F64)
    z = m @ w + 0.25
    np.testing.assert_allclose(float(got),
                               np.mean(np.log(1 / (1 + np.exp(-z)))),
                               rtol=1e-9)


def test_weld_session_routes_the_array_kernels():
    loss, feed = _logreg_graph(PORT, *_logreg_data())
    stats: dict = {}
    was = t_kernelplan.DEFAULT_KERNELIZE
    t_kernelplan.set_default_kernelize("always")
    try:
        t_weldflow.Session("weld").run(loss, feed, collect_stats=stats)
    finally:
        t_kernelplan.set_default_kernelize(was)
    assert stats["kernelize.matvec"] == 2
    assert stats["kernelize.map_elementwise"] == 1
    assert stats["kernelize.filter_reduce_sum"] == 1


def test_a_body_the_generator_cannot_emit_stays_generic():
    """A field of a computed struct (a select between two structs) is
    elementwise, but the generator does not emit it: the planner refuses
    the route at match time, records why, and the loop runs generic."""
    ir, wt = t_ir, t_wt
    x = np.random.RandomState(8).randn(100)
    o = t_lazy.NewWeldObject(x, None)

    def body(v):
        two = ir.MakeStruct((v, ir.BinOp("*", v, ir.Literal(2.0, wt.F64))))
        neg = ir.MakeStruct((ir.UnaryOp("neg", v), v))
        sel = ir.Select(ir.BinOp(">", v, ir.Literal(0.0, wt.F64)), two, neg)
        return ir.BinOp("+", ir.GetField(sel, 1), ir.Literal(1.0, wt.F64))

    expr = t_M.map_(ir.Ident(o.obj_id, o.weld_type()), body)
    obj = t_lazy.NewWeldObject([o], expr)
    stats: dict = {}
    got = t_lazy.Evaluate(obj, kernelize="always", collect_stats=stats).value
    assert "kernelize.map_elementwise" not in stats
    refused = stats["kernelplan"]["refused"]["map_elementwise"]
    assert any("computed struct" in why for why in refused)
    np.testing.assert_array_equal(got, np.where(x > 0, x * 2.0, x) + 1.0)


def test_map_chain_is_planned_with_its_ir_body():
    """The KernelCall carries the body as an IR lambda (the CUDA route
    generates its kernel from it) and the source it emits names every
    column and free scalar."""
    loss, feed = _logreg_graph(PORT, *_logreg_data())
    obj, _ = t_weldflow.transform_graph(loss, feed)
    stats: dict = {}
    t_lazy.Evaluate(obj, kernelize="always", collect_stats=stats)
    calls = [n for n in t_ir.walk(stats["plan.ir"])
             if isinstance(n, t_ir.KernelCall) and n.kernel == "map_elementwise"]
    assert len(calls) == 1
    src = t_mc.emit_source(calls[0].fns[0])
    assert src.col_dtypes == (torch.float64,)
    assert len(src.scalars) == 1 and src.scalar_dtypes == (torch.float64,)
    assert src.out_dtype == torch.float64
    assert "__global__" in src.text and "WELD_QUAL" in src.text


def test_free_scalars_reach_the_kernel_as_0_dim_tensors():
    """A scalar program input (logreg's bias) is encoded as a one-element
    column; the kernel's argument is its 0-dim value, and a longer column
    is refused."""
    env = {"b": torch.tensor([0.25], dtype=torch.float64),
           "s": (torch.tensor(3), torch.tensor(-1.5)),
           "v": torch.arange(3.0)}
    got = t_mc.scalar_value(env, "b", ())
    assert got.shape == () and float(got) == 0.25
    assert float(t_mc.scalar_value(env, "s", (1,))) == -1.5
    with pytest.raises(ValueError, match="not a scalar"):
        t_mc.scalar_value(env, "v", ())
    with pytest.raises(ValueError, match="not bound"):
        t_mc.scalar_value(env, "w", ())


def test_plan_matches_cudf_linalg_nodes():
    ir, wt = t_ir, t_wt
    a = ir.Ident("a", wt.Vec(wt.Vec(wt.F64)))
    v = ir.Ident("v", wt.Vec(wt.F64))
    stats: dict = {}
    planned = plan_kernels(ir.CUDF("linalg.matvec", (a, v), wt.Vec(wt.F64)),
                           input_shapes={"a": (100, 8), "v": (8,)},
                           stats=stats, mode="always")
    assert isinstance(planned, ir.KernelCall) and planned.kernel == "matvec"
    assert dict(planned.params)["dims"] == (100, 8, 1)
    ai = ir.Ident("ai", wt.Vec(wt.Vec(wt.I64)))
    kept = plan_kernels(ir.CUDF("linalg.matmul", (ai, ai),
                                wt.Vec(wt.Vec(wt.I64))),
                        input_shapes={"ai": (4, 4)}, stats={}, mode="always")
    assert isinstance(kept, ir.CUDF)  # i64 products stay generic


# ---------------------------------------------------------------------------
# the map-chain generator's semantics, compiled as host C++
# (the cases are shared with the card's tests, tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Every case's generated source compiled as host C++, in parallel."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    out_dir = tmp_path_factory.mktemp("mapchain")

    def build(name):
        cols, fn, _, _ = GEN_CASES[name]
        src = t_mc.emit_source(gen_lambda(cols, fn))
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(src.text)
        so = out_dir / f"{name}.so"
        r = subprocess.run([cxx, "-O0", "-ffp-contract=off", "-std=c++17",
                            "-shared", "-fPIC", "-DWELD_MC_HOST", "-o",
                            str(so), str(cpp)],
                           capture_output=True, text=True)
        return name, (src, so, r.returncode, r.stderr)

    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(pool.map(build, HOST_CASES))


#: the card's zero-divisor cases trap on a host CPU (test_torch_cuda.py)
HOST_CASES = sorted(set(GEN_CASES) - CARD_ONLY)


@pytest.mark.parametrize("name", HOST_CASES)
def test_generated_body_matches_the_generic_emitter(name, host_libs):
    cols, fn, exact, scalars = GEN_CASES[name]
    src, so, rc, err = host_libs[name]
    assert rc == 0, err
    rng = np.random.RandomState(sum(map(ord, name)))
    n = 1000
    data = [np.ascontiguousarray(column(rng, dt, n, kind))
            for dt, kind in cols]
    env_t = plain_env(scalars, "cpu")
    lam = gen_lambda(cols, fn)
    # the generic emitter's result (the plain version) on torch columns
    want = t_mc.stage_plain(lam, env_t, "cpu")(
        *[torch.from_numpy(d) for d in data])
    want = torch.broadcast_to(want, (n,)).numpy()
    assert np.dtype(want.dtype) == np.dtype(
        str(src.out_dtype).replace("torch.", ""))
    # the generated body, compiled as host C++
    lib = ctypes.CDLL(str(so))
    lib.weld_map_host.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_void_p, ctypes.c_longlong]
    sc_arrays = []
    for (sname, path), dt in zip(src.scalars, src.scalar_dtypes):
        v = env_t[sname]
        for p in path:
            v = v[p]
        sc_arrays.append(np.array(v.item(), dtype=str(dt).replace(
            "torch.", "")))
    P = ctypes.c_void_p
    got = np.empty(n, dtype=want.dtype)
    lib.weld_map_host((P * len(data))(*[d.ctypes.data for d in data]),
                      (P * max(len(sc_arrays), 1))(
                          *[a.ctypes.data for a in sc_arrays]),
                      got.ctypes.data, n)
    if exact == "exact" or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    elif exact == "bitwise":  # ("sqrt" is held as libm on the CPU)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan], want[~nan])
        ui = np.uint64 if want.dtype == np.float64 else np.uint32
        np.testing.assert_array_equal(got[~nan].view(ui), want[~nan].view(ui))
    else:
        rtol = 1e-5 if want.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol,
                                   equal_nan=True)


def test_generator_covers_every_unary_op():
    from repro_torch.core.backend.torchgen import _UNARY

    covered = {op for op in _UNARY
               if any(name.startswith(op + "_") for name in GEN_CASES)}
    covered |= {"neg", "abs", "floor", "not"} & set(_UNARY)
    assert covered == set(_UNARY)
    assert set(t_ir.UNARYOPS) == set(_UNARY)
