"""Entry points of the port, and the functions its ranks run on a mesh.

Counterpart of the JAX package's `__graft_entry__.py`:

- `entry(device=None)`: the single-device forward step of the Placeholder
  prover core (NTT -> pointwise constraint math -> inverse NTT) with example
  arguments, on the card by default;
- `dryrun_multichip(n_devices, device=None)`: a world of `n_devices` ranks
  (`launch.py`; one card a rank, or gloo on the CPU for device="cpu") runs
  the distributed prover-core steps and checks each against the
  single-device function: the four-step NTT with its all-to-all, a sharded
  pointwise square with a cross-rank sum, the inverse NTT, a 2^11-point MSM
  against a pool oracle, a precommit root, the query gather, and a
  mesh-sharded 2^10-row Placeholder proof equal to the single-device proof
  and verified.

Every other public function here is a rank's call, `fn(mesh, device,
**kwargs)` (`launch.start`): the tests run the CPU cases of the mesh layer
through the `mesh_*` functions, and `chip_smoke.py` runs `mesh_path` on the
card.
"""
from __future__ import annotations

import contextlib
import random
import tempfile
import time

import torch
import torch.distributed as dist

from . import launch
from .fields import curves as CV
from .fields.params import FIELDS
from .ops import limbs as L


def entry(device=None):
    """(forward, (x, y)): forward(x, y) = iNTT(NTT(x) * NTT(y) + NTT(x))
    over bls12-381 Fr at 2^10, the Placeholder gates argument's inner loop;
    x and y on `device` (default the card)."""
    from .ops import ntt as NTT

    fs = FIELDS["bls12_381_fr"]
    device = L.resolve_device(device)
    n = 1 << 10

    def forward(x, y):
        ex = NTT.ntt_raw(fs, x)
        ey = NTT.ntt_raw(fs, y)
        prod = L.add(fs, L.mont_mul(fs, ex, ey), ex)
        return NTT.ntt_raw(fs, prod, inverse=True)

    x = L.encode(fs, list(range(1, n + 1)), device)
    y = L.encode(fs, list(range(2, n + 2)), device)
    return forward, (x, y)


# ---------------------------------------------------------------------------
# launch counts (the kernels' wrappers count each launch)
# ---------------------------------------------------------------------------

def _count_dicts() -> list[dict]:
    from .ops import hopper_curve as HC
    from .ops import hopper_field as HF
    from .ops import hopper_hash as HH
    from .ops import hopper_msm as HM
    from .ops import mxu_ntt as MX
    from .ops import sha256 as SH
    return [HF.LAUNCHES, HM.LAUNCHES, HH.LAUNCHES, HC.LAUNCHES, SH.LAUNCHES,
            MX.LAUNCHES]


class Launches:
    """Kernel launches made inside `with launches.counting():` blocks,
    summed by kernel; what runs outside them (the single-device references
    a check compares with) is not counted."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def counting(self):
        before = [dict(d) for d in _count_dicts()]
        try:
            yield
        finally:
            for d, was in zip(_count_dicts(), before):
                for k, v in d.items():
                    self.counts[k] = self.counts.get(k, 0) + v - was.get(k, 0)


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# ---------------------------------------------------------------------------
# rank calls of the CPU tests (small sizes, inputs given by the caller)
# ---------------------------------------------------------------------------

def mesh_ntt(mesh, device, field: str, coeffs: list[int],
             roundtrip: bool = False) -> list[int]:
    """`distributed_ntt` of `coeffs` (natural order), or with `roundtrip`
    its inverse applied to that: canonical ints."""
    from .parallel.ntt import distributed_ntt
    fs = FIELDS[field]
    out = distributed_ntt(fs, L.encode(fs, coeffs, device), mesh)
    if roundtrip:
        out = distributed_ntt(fs, out, mesh, inverse=True)
    return L.decode(fs, out)


def mesh_msm(mesh, device, curve: str, points: list, scalars: list[int],
             c: int = 8, group: str = "g1", ranks: int | None = None,
             on_mesh: bool = True):
    """`distributed_msm` over the mesh, or (`on_mesh=False`) over the first
    2^k of the first `ranks` ranks of the world (the legacy signature)."""
    from .parallel.msm import distributed_msm
    return distributed_msm(CV.CURVES[curve], points, scalars,
                           mesh if on_mesh else None, ranks=ranks, c=c,
                           group=group, device=device)


def mesh_config(mesh, device, mesh_shape: tuple) -> dict:
    """What `ZkTpuConfig(field="bls12_381_fr", transcript_hash="poseidon",
    mesh_shape=...)` builds on this world."""
    from .utils.config import ZkTpuConfig
    cfg = ZkTpuConfig(field="bls12_381_fr", transcript_hash="poseidon",
                      mesh_shape=mesh_shape)
    m = cfg.build_mesh()
    fp = cfg.build_fri_params(4)
    pp = cfg.build_placeholder_params()
    return {"field": cfg.fs.name, "mesh_x": m["x"].size(),
            "lambda": fp.lambda_, "merkle_hash": fp.merkle_hash,
            "transcript_hash": pp.transcript_hash}


def _fri_polys(fs, degree_log: int, polys: list[list[int]], device,
               lambda_: int = 4):
    from .commitments import fri as FRI
    from .poly.polynomial import Poly, PolyDFS
    params = FRI.FRIParams.build(fs, degree_log=degree_log, expand_factor=2,
                                 lambda_=lambda_, merkle_hash="poseidon")
    dfs = [PolyDFS.from_poly(Poly.from_ints(fs, cs, device)) for cs in polys]
    return params, dfs


def mesh_precommit(mesh, device, field: str, degree_log: int,
                   polys: list[list[int]], proof_index: int = 3):
    """(root, the authentication path of leaf `proof_index`) of
    `distributed_precommit` over polynomials given by their coefficients."""
    from .parallel.fri import distributed_precommit
    fs = FIELDS[field]
    params, dfs = _fri_polys(fs, degree_log, polys, device)
    pre = distributed_precommit(dfs, params.D[0], params.step_list[0],
                                params, mesh)
    return pre.root(), pre.tree.proof(proof_index)


def mesh_query_gather(mesh, device, field: str, degree_log: int,
                      polys: list[list[int]], need: list[int]):
    """`distributed_query_gather` of a distributed precommit's values at
    `need`: the (B, NL, K) digit planes, as numpy."""
    from .parallel.fri import distributed_precommit, distributed_query_gather
    fs = FIELDS[field]
    params, dfs = _fri_polys(fs, degree_log, polys, device)
    pre = distributed_precommit(dfs, params.D[0], params.step_list[0],
                                params, mesh)
    return distributed_query_gather(pre.values, need, mesh).cpu().numpy()


def mesh_placeholder(mesh, device, seed: int = 0xAB, lambda_: int = 4):
    """A Placeholder proof of `circuits.circuit_1` (bls12-381 Fr, random
    values from `random.Random(seed)`, Poseidon Merkle trees, keccak
    transcript, `lambda_` queries) proved under `mesh_context`, and the
    calls of the sharded branches it made."""
    from .arithmetization.circuits import circuit_1
    from .commitments import fri as FRI
    from .commitments.lpc import LPCScheme
    from .models.placeholder import common as C
    from .models.placeholder import preprocessor as PP
    from .models.placeholder.prover import prove
    from .parallel import fri as PF
    from .parallel.context import mesh_context

    fs = FIELDS["bls12_381_fr"]
    cs, asg, desc, _ = circuit_1(fs.p, random.Random(seed))
    params = C.PlaceholderParams(fs)
    fri_params = FRI.FRIParams.build(
        fs, degree_log=desc.rows_amount.bit_length() - 1, expand_factor=2,
        lambda_=lambda_, merkle_hash="poseidon")
    scheme = LPCScheme(fri_params)
    pub = PP.process_public(params, cs, asg, desc, scheme, device=device)
    priv = PP.process_private(params, cs, asg, desc, device=device)
    before = dict(PF.CALLS)
    with mesh_context(mesh, launch.AXIS):
        proof = prove(params, pub, priv, desc, cs, scheme.fork(),
                      device=device)
    return proof, {k: PF.CALLS[k] - before[k] for k in PF.CALLS}


# ---------------------------------------------------------------------------
# the mesh path on the card (`chip_smoke.py`): each check against the
# single-device function on the same inputs, made from a seed
# ---------------------------------------------------------------------------

def _equal(name: str, got, want) -> None:
    if isinstance(got, torch.Tensor):
        same = got.shape == want.shape and bool(torch.equal(got, want))
    else:
        same = got == want
    if not same:
        raise AssertionError(f"mesh path: {name} differs from the "
                             "single-device result")


def mesh_path(mesh, device, ntt_log: int = 20, msm_log: int = 16,
              lpc_degree_log: int = 16, rows_log: int = 16,
              lambda_: int = 40, table_bits: int = 8, seed: int = 11) -> dict:
    """The mesh layer at full width, each step against the single-device
    function on the same inputs (exact equality), raising on the first
    difference. Returns the seconds of each distributed step (host clock,
    the device drained), the launches made by them, the sharded branches'
    calls and the rank count."""
    from .commitments import fri as FRI
    from .ops import hopper_field as HF
    from .ops import msm_affine as MA
    from .parallel import fri as PF
    from .parallel.context import axis_size, mesh_context
    from .parallel.msm import distributed_msm
    from .parallel.ntt import distributed_ntt
    from .tools.lpc_fixture import LPCRun
    from .tools.placeholder_fixture import PlaceholderRun
    from .utils.checkpoint import CheckpointManager, msm_checkpointed
    from .convert import placeholder_proof_as_plain

    launches = Launches()
    secs: dict[str, float] = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fs = FIELDS["bls12_381_fr"]

    def timed(name, fn):
        t0 = _sync(device)
        with launches.counting():
            out = fn()
        secs[name] = _sync(device) - t0
        return out

    # NTT at 2^ntt_log and its inverse round trip
    digits = torch.randint(0, 1 << 16, (fs.nl, 1 << ntt_log), generator=gen,
                           device=device, dtype=torch.int64)
    digits[-1] %= int(fs.p_limbs[-1])
    x = digits.to(torch.int32)
    # the first call also builds the twiddle table and opens the
    # communicators; the second is the steady state
    timed("ntt_first", lambda: distributed_ntt(fs, x, mesh))
    fwd = timed("ntt", lambda: distributed_ntt(fs, x, mesh))
    _equal("distributed_ntt", fwd, HF.ntt_hopper(fs, x))
    back = timed("intt", lambda: distributed_ntt(fs, fwd, mesh, inverse=True))
    _equal("the inverse round trip", back, x)
    del digits, x, fwd, back

    # MSM at 2^msm_log alt_bn128 G1 points against MSMBases.run
    curve = CV.ALT_BN128
    rng = random.Random(seed)
    pool, acc = [], None
    for _ in range(256):
        acc = CV.g1_add(curve, acc, curve.g1)
        pool.append(acc)
    n = 1 << msm_log
    pts = [pool[rng.randrange(256)] for _ in range(n)]
    sc = [rng.randrange(curve.fr.p) for _ in range(n)]
    got = timed("msm", lambda: distributed_msm(curve, pts, sc, mesh,
                                               device=device))
    want = MA.MSMBases(curve, pts, "g1", 8, device).run(sc)
    _equal("distributed_msm", got, want)

    # msm_checkpointed, whole and resumed after half its windows
    with tempfile.TemporaryDirectory(prefix="zk_msm_ckpt_") as ckpt:
        whole = timed("msm_checkpointed", lambda: msm_checkpointed(
            curve, pts, sc, ckpt, c=8, device=device))
        _equal("msm_checkpointed", whole, want)
        mgr = CheckpointManager(ckpt)
        _, meta = mgr.load("msm")
        half = len(meta["window_results"]) // 2
        meta["window_results"] = meta["window_results"][:half]
        mgr.save("msm", meta=meta)
        resumed = timed("msm_checkpointed_resumed", lambda: msm_checkpointed(
            curve, pts, sc, ckpt, c=8, device=device))
        _equal("msm_checkpointed after a cut", resumed, want)
    secs["msm_checkpoint_windows"] = half

    # precommit of the LPC fixture's batch 0 at D0 = 2^(degree_log + 2),
    # and the query gather of lambda queries' cosets
    run = LPCRun(lpc_degree_log, lambda_, device)
    polys = run.scheme._polys[0]
    params = run.params
    d0, step = params.D[0], params.step_list[0]
    pre = timed("precommit", lambda: PF.distributed_precommit(
        polys, d0, step, params, mesh))
    ref = FRI.precommit(polys, d0, step, params)
    _equal("distributed_precommit root", pre.root(), ref.root())
    leaves = [rng.randrange(pre.tree.n_leaves) for _ in range(lambda_)]
    _equal("distributed_precommit paths", pre.tree.proofs(leaves),
           ref.tree.proofs(leaves))
    need = sorted({j for xi in (rng.randrange(d0.n) for _ in range(lambda_))
                   for pair in FRI.coset_enum(xi, step, d0.n) for j in pair})
    gathered = timed("query_gather", lambda: PF.distributed_query_gather(
        pre.values, need, mesh))
    _equal("distributed_query_gather", gathered, pre.values.index_select(
        -1, torch.tensor(need, dtype=torch.int64, device=device)))
    del pre, ref, run, polys

    # one Placeholder prove under mesh_context against the single-device one
    prun = PlaceholderRun(rows_log, device, lambda_=lambda_,
                          table_bits=table_bits)
    prun.preprocess()
    single, challenge = prun.prove()
    calls = dict(PF.CALLS)
    with mesh_context(mesh, launch.AXIS):
        sharded, sharded_challenge = timed("placeholder_prove", prun.prove)
    calls = {k: PF.CALLS[k] - calls[k] for k in PF.CALLS}
    _equal("the mesh-sharded Placeholder proof",
           placeholder_proof_as_plain(sharded),
           placeholder_proof_as_plain(single))
    _equal("the next challenge", sharded_challenge, challenge)
    t0 = time.perf_counter()
    ok, verifier_challenge = prun.verify(sharded)
    secs["placeholder_verify"] = time.perf_counter() - t0
    if not ok or verifier_challenge != challenge:
        raise AssertionError("mesh path: the sharded proof was rejected")
    if not calls["distributed_precommit"] or \
            not calls["distributed_query_gather"]:
        raise AssertionError(f"mesh path: a sharded branch never ran "
                             f"({calls})")
    return {"ranks": axis_size(mesh, launch.AXIS), "seconds": secs,
            "launches": launches.counts, "sharded_calls": calls}


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------

def _dryrun_rank(mesh, device) -> dict:
    """The stages of `dryrun_multichip` on one rank; rank 0 prints them."""
    from .commitments import fri as FRI
    from .ops import ntt as NTT
    from .parallel.context import axis_rank, axis_size, mesh_context
    from .parallel.fri import distributed_precommit, distributed_query_gather
    from .parallel.msm import distributed_msm
    from .parallel.ntt import distributed_ntt
    from .poly.polynomial import Poly, PolyDFS
    from .tools.placeholder_fixture import PlaceholderRun
    from .convert import placeholder_proof_as_plain

    t_start = time.perf_counter()
    d = axis_size(mesh, launch.AXIS)
    me = axis_rank(mesh, launch.AXIS)

    def stage(msg):
        if me == 0:
            print(f"dryrun[{time.perf_counter() - t_start:7.1f}s] {msg}",
                  flush=True)

    fs = FIELDS["bls12_381_fr"]
    n = max(1 << 8, 4 * d * d)
    x = L.encode(fs, list(range(1, n + 1)), device)
    stage(f"mesh of {d} ranks on {device.type}, n={n}")
    ev = distributed_ntt(fs, x, mesh)
    _equal("distributed_ntt", ev, NTT.ntt(fs, x))
    stage("distributed NTT (all-to-all four-step) ok")

    # sharded pointwise square and a cross-rank sum of it
    per = n // d
    sq = L.mont_mul(fs, ev[:, me * per:(me + 1) * per],
                    ev[:, me * per:(me + 1) * per])
    part = NTT.sum_reduce(fs, sq).contiguous()
    parts = [torch.empty_like(part) for _ in range(d)]
    dist.all_gather(parts, part, group=mesh.get_group(launch.AXIS))
    total = parts[0]
    for p in parts[1:]:
        total = L.add(fs, total, p)
    whole = L.mont_mul(fs, ev, ev)
    _equal("the cross-rank sum", total, NTT.sum_reduce(fs, whole))
    allsq = [torch.empty_like(sq) for _ in range(d)]
    dist.all_gather(allsq, sq.contiguous(), group=mesh.get_group(launch.AXIS))
    back = distributed_ntt(fs, torch.cat(allsq, dim=-1), mesh, inverse=True)
    _equal("the inverse NTT", back, NTT.ntt(fs, whole, inverse=True))
    stage("sharded pointwise math + cross-rank sum + inverse NTT ok")

    curve = CV.ALT_BN128
    r = random.Random(7)
    n_pts = max(1 << 11, 8 * d)
    pool, acc = [], None
    for _ in range(256):
        acc = CV.g1_add(curve, acc, curve.g1)
        pool.append(acc)
    sel = [r.randrange(256) for _ in range(n_pts)]
    sc = [r.randrange(curve.fr.p) for _ in range(n_pts)]
    got = distributed_msm(curve, [pool[j] for j in sel], sc, mesh,
                          device=device)
    tot = sum(s * (j + 1) for j, s in zip(sel, sc)) % curve.fr.p
    _equal("distributed_msm", got, CV.g1_mul(curve, curve.g1, tot))
    stage(f"distributed MSM {n_pts} pts (all_gather + Jacobian tree) ok")

    deg_log = max(10, (d - 1).bit_length() + 1)
    params = FRI.FRIParams.build(fs, degree_log=deg_log, expand_factor=2,
                                 lambda_=4, merkle_hash="poseidon")
    cols = [PolyDFS.from_poly(Poly.from_ints(
        fs, [r.randrange(fs.p) for _ in range(1 << deg_log)], device))
        for _ in range(8)]
    pre = distributed_precommit(cols, params.D[0], params.step_list[0],
                                params, mesh)
    ref = FRI.precommit(cols, params.D[0], params.step_list[0], params)
    _equal("distributed_precommit root", pre.root(), ref.root())
    stage(f"distributed precommit of 8 columns ({pre.tree.n_leaves} "
          "leaves) equal to the single-device root")
    need = sorted({(7 * i) % params.D[0].n for i in range(3 * d)})
    _equal("distributed_query_gather",
           distributed_query_gather(pre.values, need, mesh),
           pre.values[:, :, need])
    stage("distributed FRI query serving ok")

    run = PlaceholderRun(10, device, lambda_=8, seed=5)
    run.preprocess()
    single, _ = run.prove()
    stage("single-device placeholder prove (2^10 rows) ok")
    with mesh_context(mesh, launch.AXIS):
        sharded, _ = run.prove()
    _equal("the mesh-sharded Placeholder proof",
           placeholder_proof_as_plain(sharded),
           placeholder_proof_as_plain(single))
    if not run.verify(sharded)[0]:
        raise AssertionError("the mesh-sharded Placeholder proof was "
                             "rejected")
    stage("distributed placeholder prove ok (proof equal to the "
          "single-device one, verifies)")
    return {"ranks": d, "n": n, "msm": n_pts,
            "fri_leaves": pre.tree.n_leaves,
            "placeholder_rows": run.desc.rows_amount,
            "seconds": time.perf_counter() - t_start}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dryrun's stages on a world of `n_devices` ranks: one card a
    rank (the default), or gloo ranks on the CPU for device="cpu". Raises
    if a stage disagrees with its single-device result or a rank fails;
    returns rank 0's summary."""
    device_type = L.resolve_device(device).type
    summary = launch.run(n_devices, [(f"{__name__}:_dryrun_rank", {})],
                         device_type)[0][0]
    print(f"dryrun_multichip: {summary} ok", flush=True)
    return summary
