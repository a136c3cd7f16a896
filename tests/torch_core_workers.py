"""Per-rank bodies for the tests of the port's native core
(``tests/test_torch_core.py``) and of its PyTorch frontend
(``tests/test_torch_frontend.py``).

They run inside ``horovod_tpu_torch.testing.run_world`` children
(spawned, gloo), so this module imports no JAX. Inputs arrive as numpy
arrays stacked ``[N, ...]`` (row r is rank r's); results go back as
numpy, or as ``("err", type name, message)`` for a case that raised.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.testing import watching_calls


def _np(t):
    """A numpy copy of ``t`` (bf16 widened to f32)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@contextlib.contextmanager
def recording_plans(core, plans):
    """Append each plan's tensor names to ``plans`` while open."""
    run = core._execute_one

    def spy(resp, handles):
        plans.append(list(resp.tensor_names))
        return run(resp, handles)

    core._execute_one = spy
    try:
        yield
    finally:
        del core._execute_one


def _enqueue_in_one_cycle(core, start, tries=3):
    """Run ``start()`` (which enqueues named ops and returns their
    handles) right after a barrier, with a 200 ms cycle, until its names
    come back as one plan (a cycle boundary may split them; every rank
    sees the same plans, so every rank retries alike). Returns
    ``(results, plans, all_reduce calls)`` of the last try."""
    saved = core.cycle_time_ms
    core.cycle_time_ms = 200.0
    try:
        for attempt in range(tries):
            plans, calls = [], []
            dist.barrier()
            with recording_plans(core, plans), watching_calls(
                    C.dist, ["all_reduce"], lambda *a: calls.append(1)):
                outs = [C.synchronize(h) for h in start(attempt)]
            if len(plans) == 1:
                break
        return outs, plans, len(calls)
    finally:
        core.cycle_time_ms = saved


def core_worker(inp):
    """Named async ops through the native core against their sync forms,
    and the core's own behaviours: fusion bins, one plan a cycle,
    duplicates, the response cache, join's zero backfill."""
    r, n = hvd.rank(), hvd.size()
    core = hvd.basics.core()
    assert core is not None
    mine = {k: _t(v[r]) for k, v in inp.items()}
    x, rows = mine["x"], mine["rows"]
    out = {}
    pairs = {
        "sum": (lambda: C.allreduce_async(x, C.Sum, name="sum"),
                lambda: C.allreduce(x, C.Sum)),
        "avg": (lambda: C.allreduce_async(x, C.Average, name="avg"),
                lambda: C.allreduce(x, C.Average)),
        "prepost": (lambda: C.allreduce_async(
            x, C.Average, name="prepost", prescale_factor=0.5,
            postscale_factor=3.0),
            lambda: C.allreduce(x, C.Average, prescale_factor=0.5,
                                postscale_factor=3.0)),
        "allgather": (lambda: C.allgather_async(x, name="ag"),
                      lambda: C.allgather(x)),
        "broadcast": (lambda: C.broadcast_async(x, n - 1, name="bc"),
                      lambda: C.broadcast(x, n - 1)),
        "alltoall": (lambda: C.alltoall_async(mine["a2a"], name="a2a"),
                     lambda: C.alltoall(mine["a2a"])),
        "reducescatter_sum": (
            lambda: C.reducescatter_async(rows, C.Sum, name="rs"),
            lambda: C.reducescatter(rows, C.Sum)),
        "reducescatter_avg": (
            lambda: C.reducescatter_async(rows, C.Average, name="rsa"),
            lambda: C.reducescatter(rows, C.Average)),
    }
    for key, (named, sync) in pairs.items():
        out[key] = (_np(C.synchronize(named())), _np(sync()))

    # allgathers ready in one cycle: one plan, run by grouped_allgather
    gl = [x, rows, mine["a2a"].to(torch.float64)]
    got, plans, _ = _enqueue_in_one_cycle(core, lambda k: [
        C.allgather_async(t, name=f"gag{k}.{i}") for i, t in enumerate(gl)])
    out["grouped_allgather"] = ([_np(t) for t in got],
                                [_np(t) for t in C.grouped_allgather(gl)])
    out["grouped_allgather_plans"] = plans

    # mixed dtypes in one plan, each against its own sync allreduce
    mixed = [x, x.double(), x.to(torch.bfloat16), x.half(),
             mine["ints"].to(torch.int32), mine["ints"]]
    got, plans, calls = _enqueue_in_one_cycle(core, lambda k: [
        C.allreduce_async(t, C.Sum, name=f"mix{k}.{i}")
        for i, t in enumerate(mixed)])
    out["mixed"] = ([_np(t) for t in got],
                    [_np(C.allreduce(t, C.Sum)) for t in mixed])
    out["mixed_plans"], out["mixed_calls"] = plans, calls

    # k names ready in one cycle: one plan, one all_reduce
    ks = [x * (i + 1) for i in range(6)]
    got, plans, calls = _enqueue_in_one_cycle(core, lambda k: [
        C.allreduce_async(t, C.Average, name=f"k{k}.{i}")
        for i, t in enumerate(ks)])
    out["one_cycle"] = ([_np(t) for t in got],
                        [_np(C.allreduce(t, C.Average)) for t in ks])
    out["one_cycle_plans"], out["one_cycle_calls"] = plans, calls

    # the same tensor in three bins: alone, with mates, and split off by a
    # fusion threshold smaller than the mates
    a = mine["a"]
    bins, bin_plans = [], []
    got, plans, _ = _enqueue_in_one_cycle(
        core, lambda k: [C.allreduce_async(a, C.Average, name=f"a{k}")])
    bins.append(_np(got[0]))
    bin_plans.append(plans)
    mates = [mine["m1"], a, mine["m2"]]
    got, plans, _ = _enqueue_in_one_cycle(core, lambda k: [
        C.allreduce_async(t, C.Average, name=f"b{k}.{i}")
        for i, t in enumerate(mates)])
    bins.append(_np(got[1]))
    bin_plans.append(plans)
    threshold = core.fusion_threshold
    core.fusion_threshold = a.numel() * 4
    try:
        got, plans, _ = _enqueue_in_one_cycle(core, lambda k: [
            C.allreduce_async(t, C.Average, name=f"c{k}.{i}")
            for i, t in enumerate(mates)], tries=1)
    finally:
        core.fusion_threshold = threshold
    bins.append(_np(got[1]))
    bin_plans.append(plans)
    out["bins"], out["bins_plans"] = bins, bin_plans
    out["bins_sync"] = _np(C.allreduce(a, C.Average))

    # a duplicate outstanding name is refused; the first op completes
    h = C.allreduce_async(x, C.Sum, name="dup")
    try:
        C.allreduce_async(x, C.Sum, name="dup")
        out["duplicate"] = None
    except ValueError as e:
        out["duplicate"] = str(e)
    out["duplicate_first"] = _np(C.synchronize(h))

    # the steady state: the same name every round rides the response cache
    hits0 = core.cache_hit_count()
    out["cached"] = [_np(C.synchronize(C.allreduce_async(
        x, C.Sum, name="cached"))) for _ in range(5)]
    out["cache_hits"] = core.cache_hit_count() - hits0

    # Adasum: one name alone, and three of different sizes in one plan
    # (the grouped combine, each tensor with its own scalars), each
    # against its own sync Adasum
    out["adasum"] = (_np(C.synchronize(C.allreduce_async(
        x, C.Adasum, name="adasum"))), _np(C.allreduce(x, C.Adasum)))
    ad = [x, mine["a"], mine["m1"]]
    got, plans, _ = _enqueue_in_one_cycle(core, lambda k: [
        C.allreduce_async(t, C.Adasum, name=f"ad{k}.{i}")
        for i, t in enumerate(ad)])
    out["adasum_group"] = ([_np(t) for t in got],
                           [_np(C.allreduce(t, C.Adasum)) for t in ad])
    out["adasum_group_plans"] = plans

    # join: rank 0 has three batches, every other rank one; the ranks
    # that joined take part in rank 0's later reductions with zeros
    sums = []
    for i in range(3 if r == 0 else 1):
        h = C.allreduce_async(torch.full((3,), float(r + 1)), C.Sum,
                              name=f"step{i}")
        sums.append(_np(C.synchronize(h)))
    out["join_sums"] = sums
    out["join_last"] = C.join()
    return out


# --------------------------------------------------------------------------
# the PyTorch frontend: a counterpart of each case of tests/test_torch.py,
# on a world of ranks; each returns what its test checks


FRONTEND = {}


def _case(f):
    FRONTEND[f.__name__] = f
    return f


def _thvd():
    import horovod_tpu_torch.torch as thvd

    return thvd


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test checks what it was
        return (type(e).__name__, str(e))
    return None


@_case
def basics_and_flags(t):
    """The frontend's identity queries and build flags on this rank."""
    from horovod_tpu_torch import basics

    return dict(
        rank=t.rank(), size=t.size(), cross_rank=t.cross_rank(),
        cross_size=t.cross_size(), process_rank=t.process_rank(),
        process_size=t.process_size(), homogeneous=t.is_homogeneous(),
        core=basics.core() is not None,
        flags={f: getattr(t, f)() for f in (
            "mpi_threads_supported", "mpi_built", "gloo_built", "nccl_built",
            "ddl_built", "ccl_built", "xla_built", "gpu_available",
            "mpi_enabled", "gloo_enabled")})


@_case
def allreduce_average(t):
    r = t.rank()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + r
    out = t.allreduce(x, name="tar.avg")
    return _np(out), str(out.dtype)


@_case
def allreduce_sum(t):
    return _np(t.allreduce(torch.ones(5) * (t.rank() + 1), op=t.Sum,
                           name="tar.sum"))


@_case
def allreduce_average_kwarg_conflict(t):
    return _raises(lambda: t.allreduce(torch.ones(2), average=True, op=t.Sum))


@_case
def allreduce_inplace(t):
    x = torch.ones(4) * (t.rank() + 1)
    r = t.allreduce_(x, op=t.Sum, name="tar.inp")
    return r is x, _np(x)


@_case
def allreduce_fp16_compression(t):
    x = torch.rand(8, generator=_gen(t.rank()))
    out = t.allreduce(x, name="tar.fp16", compression=t.Compression.fp16)
    return _np(out), str(out.dtype)


@_case
def allreduce_int_dtype(t):
    x = torch.arange(6, dtype=torch.int32) * (t.rank() + 1)
    out = t.allreduce(x, op=t.Sum, name="tar.int")
    return _np(out), str(out.dtype)


@_case
def allreduce_grad(t):
    x = torch.rand(3, 3, generator=_gen(t.rank())).requires_grad_(True)
    t.allreduce(x, op=t.Sum, name="tar.grad").sum().backward()
    return _np(x.grad)


@_case
def allreduce_async(t):
    h = t.allreduce_async(torch.ones(3) * (t.rank() + 1), op=t.Sum,
                          name="tar.async")
    out = t.synchronize(h)
    return _np(out), t.poll(h)


@_case
def allreduce_async_inplace(t):
    x = torch.ones(3) * (t.rank() + 1)
    h = t.allreduce_async_(x, op=t.Sum, name="tar.async.inp")
    return t.synchronize(h) is x, _np(x)


@_case
def package_async_inplace(t):
    """The top-level package's in-place async spellings write the tensor
    they were given on ``synchronize``."""
    x = torch.ones(3) * (t.rank() + 1)
    h = hvd.allreduce_async_(x, hvd.Sum, name="pkg.ar.inp")
    ar = (hvd.synchronize(h) is x, _np(x))
    y = torch.arange(4, dtype=torch.float32) + t.rank()
    h = hvd.broadcast_async_(y, 1, name="pkg.bc.inp")
    return ar, (hvd.synchronize(h) is y, _np(y))


@_case
def duplicate_name_rejected(t):
    h = t.allreduce_async(torch.ones(2), name="tar.dup")
    err = _raises(lambda: t.allreduce_async(torch.ones(2), name="tar.dup"))
    t.synchronize(h)
    return err


@_case
def grouped_allreduce(t):
    xs = [torch.full((2, 2), float(i + 1 + t.rank())) for i in range(3)]
    return [_np(o) for o in t.grouped_allreduce(xs, op=t.Sum,
                                                name="tar.grp")]


@_case
def allgather(t):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * t.rank()
    return _np(t.allgather(x, name="tag.basic"))


@_case
def allgather_grad(t):
    x = torch.rand(2, 2, generator=_gen(t.rank())).requires_grad_(True)
    t.allgather(x, name="tag.grad").sum().backward()
    return _np(x.grad)


@_case
def broadcast(t):
    x = torch.arange(4, dtype=torch.float32) + t.rank()
    return _np(t.broadcast(x, root_rank=0, name="tbc.basic"))


@_case
def broadcast_inplace(t):
    x = torch.ones(4) * (t.rank() + 1)
    r = t.broadcast_(x, 0, name="tbc.inp")
    return r is x, _np(x)


@_case
def broadcast_bad_root(t):
    return _raises(lambda: t.broadcast(torch.ones(2), root_rank=t.size()))


@_case
def join(t):
    return t.join()


@_case
def broadcast_object(t):
    obj = {"lr": 0.1, "steps": [1, 2, 3]} if t.rank() == 0 else None
    return t.broadcast_object(obj, root_rank=0)


@_case
def allgather_object(t):
    return t.allgather_object({"r": t.rank()})


def _xent_steps(t, model, opt, x, y, steps):
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()


@_case
def train_step(t):
    model = _mlp()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    g = _gen(t.rank())
    x, y = torch.rand(16, 4, generator=g), torch.randint(0, 2, (16,),
                                                         generator=g)
    before = [_np(p) for p in model.parameters()]
    _xent_steps(t, model, opt, x, y, 3)
    return before, [_np(p) for p in model.parameters()]


@_case
def matches_local_sgd(t):
    """Identical batches on every rank: the averaged gradients are the
    local ones, so the wrapped SGD tracks plain SGD bit for bit."""
    m1, m2 = _mlp(), _mlp()
    o1 = torch.optim.SGD(m1.parameters(), lr=0.05)
    o2 = t.DistributedOptimizer(torch.optim.SGD(m2.parameters(), lr=0.05),
                                named_parameters=m2.named_parameters())
    g = _gen(7)
    x, y = torch.rand(8, 4, generator=g), torch.randint(0, 2, (8,),
                                                        generator=g)
    _xent_steps(t, m1, o1, x, y, 2)
    _xent_steps(t, m2, o2, x, y, 2)
    return [_np(p) for p in m1.parameters()], [_np(p) for p in m2.parameters()]


@_case
def backward_passes_per_step(t):
    model = _mlp()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 backward_passes_per_step=2)
    g = _gen(t.rank())
    x, y = torch.rand(8, 4, generator=g), torch.randint(0, 2, (8,),
                                                        generator=g)
    opt.zero_grad()
    torch.nn.functional.cross_entropy(model(x), y).backward()
    torch.nn.functional.cross_entropy(model(x), y).backward()
    opt.step()
    return [_np(p) for p in model.parameters()]


@_case
def too_many_backwards_raises(t):
    model = _mlp()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    x, y = torch.rand(4, 4, generator=_gen(1)), torch.tensor([0, 1, 0, 1])
    torch.nn.functional.cross_entropy(model(x), y).backward()
    err = _raises(lambda: torch.nn.functional.cross_entropy(
        model(x), y).backward())
    opt.synchronize()
    return err


@_case
def zero_grad_mid_step_raises(t):
    model = _mlp()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    x, y = torch.rand(4, 4, generator=_gen(1)), torch.tensor([0, 1, 0, 1])
    torch.nn.functional.cross_entropy(model(x), y).backward()
    err = _raises(opt.zero_grad)
    opt.synchronize()
    return err


@_case
def duplicate_names_rejected(t):
    model = _mlp()
    named = [("same", p) for _, p in model.named_parameters()]
    return _raises(lambda: t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), named_parameters=named))


@_case
def synchronize_then_skip(t):
    model = _mlp()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    x, y = torch.rand(4, 4, generator=_gen(t.rank())), torch.tensor([0, 1, 0, 1])
    opt.zero_grad()
    torch.nn.functional.cross_entropy(model(x), y).backward()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    return [_np(p) for p in model.parameters()]


@_case
def broadcast_parameters(t):
    torch.manual_seed(100 + t.rank())
    model = torch.nn.Linear(3, 3)
    t.broadcast_parameters(model.state_dict(), root_rank=0)
    return {k: _np(v) for k, v in model.state_dict().items()}


@_case
def broadcast_optimizer_state(t):
    torch.manual_seed(100 + t.rank())
    model = torch.nn.Linear(3, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.3 if t.rank() == 0 else 0.1,
                          momentum=0.9)
    model(torch.rand(2, 3)).sum().backward()
    opt.step()
    t.broadcast_optimizer_state(opt, root_rank=0)
    sd = opt.state_dict()
    return sd["param_groups"][0]["lr"], {
        k: _np(s["momentum_buffer"]) for k, s in sd["state"].items()}


@_case
def broadcast_optimizer_state_fresh(t):
    model = torch.nn.Linear(3, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.3, momentum=0.9)
    t.broadcast_optimizer_state(opt, root_rank=0)
    return sorted(opt.state_dict()["state"])


def _bn_pair(c, seed):
    torch.manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c)
    sbn = _thvd().SyncBatchNorm(c)
    sbn.load_state_dict(bn.state_dict())
    bn.train()
    sbn.train()
    return bn, sbn


@_case
def sync_bn_matches_local_bn_replicated(t):
    torch.manual_seed(0)
    x = torch.rand(4, 3, 5, 5)
    bn, sbn = _bn_pair(3, 0)
    y1, y2 = bn(x), sbn(x)
    return ([_np(y1), _np(bn.running_mean), _np(bn.running_var)],
            [_np(y2), _np(sbn.running_mean), _np(sbn.running_var)])


@_case
def sync_bn_backward_matches(t):
    torch.manual_seed(1)
    x = torch.rand(4, 3, 4, 4)
    x1 = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    bn, sbn = _bn_pair(3, 1)
    bn(x1).pow(2).sum().backward()
    sbn(x2).pow(2).sum().backward()
    return ([_np(x1.grad), _np(bn.weight.grad), _np(bn.bias.grad)],
            [_np(x2.grad), _np(sbn.weight.grad), _np(sbn.bias.grad)])


@_case
def sync_bn_eval_uses_running_stats(t):
    sbn = t.SyncBatchNorm(2)
    sbn.eval()
    x = torch.rand(3, 2)
    return tuple(sbn(x).shape), tuple(x.shape)


def _adasum_models():
    import copy

    torch.manual_seed(11)
    model = torch.nn.Linear(4, 2)
    return model, copy.deepcopy(model)


@_case
def adasum_matches_local_sgd(t):
    model, ref = _adasum_models()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 op=t.Adasum)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x = torch.randn(8, 4, generator=_gen(3))
    for _ in range(3):
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()
        ref_opt.zero_grad()
        ref(x).pow(2).mean().backward()
        ref_opt.step()
    return [_np(p) for p in model.parameters()], [_np(p) for p in ref.parameters()]


@_case
def adasum_backward_passes_per_step_accumulates(t):
    model, ref = _adasum_models()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.05),
                                 named_parameters=model.named_parameters(),
                                 op=t.Adasum, backward_passes_per_step=2)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.05)
    g = _gen(4)
    x1, x2 = torch.randn(4, 4, generator=g), torch.randn(4, 4, generator=g)
    opt.zero_grad()
    model(x1).pow(2).mean().backward()
    model(x2).pow(2).mean().backward()
    opt.step()
    ref_opt.zero_grad()
    ref(x1).pow(2).mean().backward()
    ref(x2).pow(2).mean().backward()
    ref_opt.step()
    return [_np(p) for p in model.parameters()], [_np(p) for p in ref.parameters()]


@_case
def adasum_skip_synchronize_rejected(t):
    model, _ = _adasum_models()
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 op=t.Adasum)

    def enter():
        with opt.skip_synchronize():
            pass

    return _raises(enter)


@_case
def ef_requires_lossy_compression(t):
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    return _raises(lambda: t.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(), error_feedback=True))


@_case
def ef_rejected_with_adasum(t):
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    return _raises(lambda: t.DistributedOptimizer(
        opt, named_parameters=model.named_parameters(), op=t.Adasum,
        compression=t.Compression.fp16, error_feedback=True))


@_case
def ef_residual_tracks_fp16_rounding(t):
    """Identical gradients on every rank: the reduced gradient is the fp16
    roundtrip of the local one, the residual ``g - fp16(g)``; the residual
    folds into the next step and rides ``state_dict``."""
    model = torch.nn.Linear(1, 1, bias=False)
    opt = t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0),
        named_parameters=model.named_parameters(),
        compression=t.Compression.fp16, error_feedback=True)
    g = 1.0 + 2.0 ** -12
    x = torch.full((1, 1), 1.0)
    (model(x) * g).sum().backward()
    opt.step()
    (p,) = [p for pg in opt.param_groups for p in pg["params"]]
    first, grad = _np(opt._ef_residual[p]), _np(p.grad)
    opt.zero_grad()
    (model(x) * g).sum().backward()
    opt.step()
    second = _np(opt._ef_residual[p])
    sd = opt.state_dict()
    opt._ef_residual.clear()
    opt.load_state_dict(sd)
    return dict(first=first, grad=grad, second=second,
                keys=sorted(sd["ef_residual"]),
                restored=_np(opt._ef_residual[p]))


@_case
def ef_works_with_adam_lazy_state_init(t):
    model = torch.nn.Linear(4, 2)
    opt = t.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters(),
        compression=t.Compression.fp16, error_feedback=True)
    g = _gen(t.rank())
    for _ in range(2):
        opt.zero_grad()
        model(torch.randn(3, 4, generator=g)).sum().backward()
        opt.step()
    return len(opt._ef_residual), [_np(p) for p in model.parameters()]


@_case
def reducescatter_sum_and_async(t):
    n = t.size()
    x = torch.arange(n * 2, dtype=torch.float32)
    out = t.reducescatter(x, op=t.Sum, name="trs")
    h = t.reducescatter_async(x, op=t.Sum, name="trs.async")
    return _np(out), _np(t.synchronize(h))


# beyond tests/test_torch.py: the frontend against the JAX package's and
# against one process; the inputs come from frontend_inputs(n)


def frontend_inputs(n: int) -> dict:
    """The extra cases' inputs for a world of ``n``, from a seed."""
    rs = np.random.RandomState(21)
    return {
        "same_x": rs.rand(8, 4).astype(np.float32),
        "same_y": rs.randint(0, 2, 8),
        "x": rs.rand(8 * n, 4).astype(np.float32),
        "y": rs.randint(0, 2, 8 * n),
        "bn_x": rs.randn(2 * n, 3, 4, 4).astype(np.float32),
        "bn_w": rs.randn(2 * n, 3, 4, 4).astype(np.float32),
        "bn_same": rs.randn(2, 3, 4, 4).astype(np.float32),
    }


def hook_optimizer_steps(thvd, inp, wrapped: str, steps: int = 3):
    """``steps`` steps of the MLP under ``thvd.DistributedOptimizer``
    (either frontend: the port's or the JAX package's) on the identical
    batch: ``wrapped`` is ``"sgd"`` (momentum 0.9) or ``"adam_fp16_ef"``.
    Returns the parameters."""
    model = _mlp(3)
    if wrapped == "sgd":
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters())
    else:
        opt = thvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters(),
            compression=thvd.Compression.fp16, error_feedback=True)
    x, y = _t(inp["same_x"]), _t(inp["same_y"])
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return [_np(p) for p in model.parameters()]


def disjoint_sgd_steps(inp, rows=None, steps: int = 3):
    """SGD (lr 0.1) on the BN-free MLP over ``rows`` of the global batch
    (all of it in one process, or this rank's rows under the port's
    DistributedOptimizer). Returns the parameters."""
    model = _mlp(4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x, y = _t(inp["x"]), _t(inp["y"])
    if rows is not None:
        t = _thvd()
        opt = t.DistributedOptimizer(opt,
                                     named_parameters=model.named_parameters())
        x, y = x[rows], y[rows]
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return [_np(p) for p in model.parameters()]


def adasum_disjoint_steps(inp, rows, steps: int = 3):
    """SGD (lr 0.1) on the BN-free MLP over this rank's ``rows`` under
    the port's ``DistributedOptimizer(op=Adasum)``. Returns the
    parameters."""
    t = _thvd()
    model = _mlp(4)
    opt = t.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 op=t.Adasum)
    x, y = _t(inp["x"])[rows], _t(inp["y"])[rows]
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return [_np(p) for p in model.parameters()]


def sync_bn_run(bn, x, w):
    """Forward and backward of ``bn`` (train mode) on ``x`` with the loss
    ``sum(bn(x) * w)``: output, input grad, weight and bias grads, running
    mean and variance."""
    x = x.clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * w).sum().backward()
    return [_np(v) for v in (y, x.grad, bn.weight.grad, bn.bias.grad,
                             bn.running_mean, bn.running_var)]


def _rows(n_per):
    r = _thvd().rank()
    return slice(r * n_per, (r + 1) * n_per)


@_case
def extra_hook_sgd(t):
    return hook_optimizer_steps(t, _INPUT, "sgd")


@_case
def extra_hook_adam_fp16_ef(t):
    return hook_optimizer_steps(t, _INPUT, "adam_fp16_ef")


@_case
def extra_disjoint_batches(t):
    return disjoint_sgd_steps(_INPUT, _rows(8))


@_case
def extra_adasum_disjoint(t):
    return adasum_disjoint_steps(_INPUT, _rows(8))


@_case
def extra_sync_bn_gathered(t):
    rows = _rows(2)
    torch.manual_seed(5)
    return sync_bn_run(t.SyncBatchNorm(3), _t(_INPUT["bn_x"])[rows],
                       _t(_INPUT["bn_w"])[rows])


@_case
def extra_sync_bn_identical(t):
    torch.manual_seed(5)
    return sync_bn_run(t.SyncBatchNorm(3), _t(_INPUT["bn_same"]),
                       _t(_INPUT["bn_same"]))


_INPUT = {}


def frontend_worker(inp, names=None):
    """The frontend cases (all, or ``names``) in turn on this rank:
    ``{case: ("ok", value) or ("err", type, message)}``."""
    t = _thvd()
    _INPUT.update(inp)
    out = {}
    for name, f in FRONTEND.items():
        if names is not None and name not in names:
            continue
        try:
            out[name] = ("ok", f(t))
        except Exception as e:  # noqa: BLE001 - reported to the test
            out[name] = ("err", type(e).__name__, str(e))
    return out
