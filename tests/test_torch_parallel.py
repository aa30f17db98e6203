"""The port's mesh layer (`parallel/`, `utils/config.py`, `entry.py`,
`launch.py`) against the JAX package's single-device results, on the CPU.

Every case runs in ONE gloo world of 4 ranks, spawned by a module-scoped
fixture (`launch.start`) while the tests compute their references; each
test asserts on its own case's result. Every rank returns the whole result
(as the JAX functions return a global array), and the ranks' results are
equal. The cases are those of `tests/test_parallel.py`, at its sizes (the
legacy `devices=` case as the first 2 ranks of the 4), then a mesh-sharded
Placeholder proof of `circuit_1` (degree_log 4, lambda 4, Poseidon trees),
equal to the port's single-device proof and to the JAX proof, accepted by
both packages' verifiers, with both sharded branches taken. Exact
equality throughout."""
import random

import numpy as np
import pytest

import circuits as CI
from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import fri as RFRI
from crypto3_zk_tpu.commitments import lpc as RLPC
from crypto3_zk_tpu.fields import curves as RCV
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.models.placeholder import common as RC
from crypto3_zk_tpu.models.placeholder import preprocessor as RPP
from crypto3_zk_tpu.models.placeholder import prover as RPR
from crypto3_zk_tpu.models.placeholder import verifier as RV
from crypto3_zk_tpu.ops import limbs as RL
from crypto3_zk_tpu.ops.msm import msm_host
from crypto3_zk_tpu.poly.domain import get_domain
from crypto3_zk_tpu.poly.polynomial import Poly as RPoly
from crypto3_zk_tpu.poly.polynomial import PolyDFS as RPolyDFS
from crypto3_zk_tpu.utils import profiling as RPROF
from crypto3_zk_tpu_torch import convert as CV
from crypto3_zk_tpu_torch import entry as EN
from crypto3_zk_tpu_torch import launch
from crypto3_zk_tpu_torch.arithmetization.circuits import circuit_1
from crypto3_zk_tpu_torch.commitments import fri as FRI
from crypto3_zk_tpu_torch.commitments.lpc import LPCScheme
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.models.placeholder import common as TC
from crypto3_zk_tpu_torch.models.placeholder import preprocessor as TPP
from crypto3_zk_tpu_torch.models.placeholder import prover as TPR
from crypto3_zk_tpu_torch.models.placeholder import verifier as TV
from crypto3_zk_tpu_torch.utils import profiling as TPROF
from crypto3_zk_tpu_torch.utils.config import ZkTpuConfig

import torch_threads  # noqa: F401  one torch thread a worker

RFS, FS = P.BLS12_381_FR, TP.BLS12_381_FR
RANKS = 4
E = "crypto3_zk_tpu_torch.entry:"
SEED = 0xAB                         # circuit_1's values
# seconds the world may take (rendezvous, each collective, the whole run):
# about 100 s on a loaded CPU, so a hang fails the file well inside the
# suite's limit instead of holding a worker for launch.start's 600 s
WORLD_TIMEOUT = 240
REF_MODULES = __import__("types").SimpleNamespace(common=RC, lpc=RLPC,
                                                  batched=RB, fri=RFRI)


def _field_ints(rng, n):
    return [rng.randrange(FS.p) for _ in range(n)]


def _cases():
    """(name -> (call, inputs)) of every case, inputs from seeds."""
    rng = random.Random(99)
    cases = {}
    for log_n in (8, 10):
        xs = _field_ints(rng, 1 << log_n)
        cases[f"ntt{log_n}"] = ((E + "mesh_ntt", {
            "field": "bls12_381_fr", "coeffs": xs}), xs)
    xs = _field_ints(rng, 1 << 9)
    cases["intt"] = ((E + "mesh_ntt", {"field": "bls12_381_fr",
                                       "coeffs": xs, "roundtrip": True}), xs)
    # 2^12 points over a pool of 64 multiples of G (test_parallel.py:43)
    c = RCV.ALT_BN128
    r = random.Random(123)
    base, acc = [], None
    for _ in range(64):
        acc = RCV.g1_add(c, acc, c.g1)
        base.append(acc)
    sel = [r.randrange(64) for _ in range(1 << 12)]
    sc = [r.randrange(c.fr.p) for _ in range(1 << 12)]
    sc[0] = 0
    cases["msm"] = ((E + "mesh_msm", {
        "curve": "alt_bn128", "points": [base[j] for j in sel],
        "scalars": sc}), (sel, sc))
    # 33 points, fewer than the mesh wants (pads), over the first 2 ranks
    r = random.Random(321)
    pts = [RCV.g1_mul(c, c.g1, r.randrange(1, c.fr.p)) for _ in range(33)]
    sc = [r.randrange(c.fr.p) for _ in range(33)]
    cases["msm_uneven"] = ((E + "mesh_msm", {
        "curve": "alt_bn128", "points": pts, "scalars": sc, "ranks": 2,
        "on_mesh": False}), (pts, sc))
    cases["config"] = ((E + "mesh_config", {"mesh_shape": (RANKS,)}), None)
    polys = [_field_ints(rng, 1 << 7) for _ in range(2)]
    cases["precommit"] = ((E + "mesh_precommit", {
        "field": "bls12_381_fr", "degree_log": 7, "polys": polys}), polys)
    r = random.Random(12)
    poly = [r.randrange(FS.p) for _ in range(64)]
    need = sorted(r.sample(range(1 << 8), 17))
    cases["query"] = ((E + "mesh_query_gather", {
        "field": "bls12_381_fr", "degree_log": 6, "polys": [poly],
        "need": need}), (poly, need))
    cases["placeholder"] = ((E + "mesh_placeholder", {"seed": SEED}), None)
    return cases


class World:
    def __init__(self):
        self.cases = _cases()
        self.names = list(self.cases)
        self.handle = launch.start(
            RANKS, [call for call, _ in self.cases.values()], "cpu",
            timeout=WORLD_TIMEOUT)

    def result(self, name):
        """Rank 0's result of a case, after checking that every rank
        returned the same."""
        per_rank = self.handle.results()
        i = self.names.index(name)
        first = per_rank[0][i]
        for other in per_rank[1:]:
            got = other[i]
            if isinstance(first, np.ndarray):
                assert np.array_equal(got, first)
            elif name == "placeholder":
                assert CV.placeholder_proof_as_plain(got[0]) == \
                    CV.placeholder_proof_as_plain(first[0])
                assert got[1] == first[1]
            else:
                assert got == first
        return first

    def inputs(self, name):
        return self.cases[name][1]


@pytest.fixture(scope="module")
def world():
    w = World()
    yield w
    w.handle.results()              # joined and stopped, even if unread


@pytest.mark.parametrize("log_n", [8, 10])
def test_distributed_ntt_matches_single_chip(world, log_n):
    xs = world.inputs(f"ntt{log_n}")
    want = RL.decode(RFS, get_domain(RFS, 1 << log_n).fft(RL.encode(RFS, xs)))
    assert world.result(f"ntt{log_n}") == want


def test_distributed_intt_roundtrip(world):
    assert world.result("intt") == world.inputs("intt")


def test_distributed_msm_matches_single(world):
    c = RCV.ALT_BN128
    sel, sc = world.inputs("msm")
    tot = sum(s * (j + 1) for j, s in zip(sel, sc)) % c.fr.p
    assert world.result("msm") == RCV.g1_mul(c, c.g1, tot)


def test_distributed_msm_small_uneven(world):
    """n smaller than the mesh wants (pads); the legacy signature: a mesh
    over the first 2 ranks, the others receive the point."""
    pts, sc = world.inputs("msm_uneven")
    assert world.result("msm_uneven") == msm_host(RCV.ALT_BN128, pts, sc)


def test_config_builds(world):
    from crypto3_zk_tpu.utils.config import ZkTpuConfig as RefConfig
    ref = RefConfig(field="bls12_381_fr", transcript_hash="poseidon",
                    mesh_shape=(RANKS,))
    assert world.result("config") == {
        "field": ref.fs.name, "mesh_x": ref.build_mesh().shape["x"],
        "lambda": ref.build_fri_params(4).lambda_,
        "merkle_hash": ref.build_fri_params(4).merkle_hash,
        "transcript_hash": ref.build_placeholder_params().transcript_hash}
    assert ZkTpuConfig().build_mesh() is None


def _ref_precommit(polys, degree_log):
    params = RFRI.FRIParams.build(RFS, degree_log=degree_log,
                                  expand_factor=2, lambda_=4,
                                  merkle_hash="poseidon")
    dfs = [RPolyDFS.from_poly(RPoly.from_ints(RFS, cs)) for cs in polys]
    return RFRI.precommit(dfs, params.D[0], params.step_list[0], params)


def test_distributed_fri_precommit_matches_single(world):
    """Sharded Poseidon leaf hashing + all_gather give the single-device
    precommit's root and paths."""
    ref = _ref_precommit(world.inputs("precommit"), 7)
    root, path = world.result("precommit")
    assert root == ref.root()
    assert path == ref.tree.proof(3)


def test_distributed_fri_query_gather(world):
    """Leaf-range-sharded query serving equals the replicated gather."""
    poly, need = world.inputs("query")
    ref = _ref_precommit([poly], 6)
    want = np.asarray(ref.values)[:, :, np.asarray(need)]
    got = world.result("query")
    assert got.dtype == np.int32 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# a mesh-sharded Placeholder proof of circuit_1
# ---------------------------------------------------------------------------

class Proofs:
    """circuit_1's proof by the JAX package and by the port on one device
    (with the port's spans on, so that the mesh proof, made with them off,
    equals it), and what their verifiers need."""

    def __init__(self):
        cs, asg, desc, self.public_input = CI.circuit_1(RFS,
                                                        random.Random(SEED))
        self.ref_circuit = (cs, asg, desc)
        self.ref_params = RC.PlaceholderParams(RFS)
        self.ref_fri = RFRI.FRIParams.build(
            RFS, degree_log=4, expand_factor=2, lambda_=4,
            merkle_hash="poseidon")
        scheme = RLPC.LPCScheme(self.ref_fri)
        self.ref_pub = RPP.process_public(self.ref_params, cs, asg, desc,
                                          scheme)
        priv = RPP.process_private(self.ref_params, cs, asg, desc)
        self.ref_proof = RPR.prove(self.ref_params, self.ref_pub, priv, desc,
                                   cs, scheme)

        tcs, tasg, tdesc, _ = circuit_1(FS.p, random.Random(SEED))
        self.circuit = (tcs, tasg, tdesc)
        self.params = TC.PlaceholderParams(FS)
        self.fri = FRI.FRIParams.build(FS, degree_log=4, expand_factor=2,
                                       lambda_=4, merkle_hash="poseidon")
        scheme = LPCScheme(self.fri)
        self.pub = TPP.process_public(self.params, tcs, tasg, tdesc, scheme,
                                      device="cpu")
        priv = TPP.process_private(self.params, tcs, tasg, tdesc,
                                   device="cpu")
        with TPROF.spans_on():
            self.proof = TPR.prove(self.params, self.pub, priv, tdesc, tcs,
                                   scheme.fork(), device="cpu")

    def verify(self, proof):
        tcs, _, tdesc = self.circuit
        return TV.verify(self.params, self.pub.common_data, proof, tdesc,
                         tcs, LPCScheme(self.fri),
                         public_input=self.public_input)

    def ref_verify(self, proof):
        cs, _, desc = self.ref_circuit
        carried = CV.placeholder_proof_from_fields(
            CV.placeholder_proof_fields(proof), REF_MODULES)
        return RV.verify(self.ref_params, self.ref_pub.common_data, carried,
                         desc, cs, RLPC.LPCScheme(self.ref_fri),
                         public_input=self.public_input)


@pytest.fixture(scope="module")
def proofs(world):
    return Proofs()


def test_mesh_placeholder_proof_equals_single_device_and_jax(world, proofs):
    sharded, calls = world.result("placeholder")
    plain = CV.placeholder_proof_as_plain(sharded)
    assert plain == CV.placeholder_proof_as_plain(proofs.proof)
    assert plain == CV.placeholder_proof_as_plain(proofs.ref_proof)


def test_mesh_placeholder_proof_verifies_in_both_packages(world, proofs):
    sharded, _ = world.result("placeholder")
    assert proofs.verify(sharded)
    assert proofs.ref_verify(sharded)


def test_mesh_placeholder_took_the_sharded_branches(world):
    """Every precommit of the prove (variable values, permutation,
    quotient, the combined Q and the FRI rounds: 32 to 8 leaves, each a
    multiple of 4) and every first-round query gather went through
    `parallel/fri.py`."""
    _, calls = world.result("placeholder")
    assert calls == {"distributed_precommit": 6,
                     "distributed_query_gather": 4}


def test_placeholder_profiling_info(proofs):
    """`utils/profiling.py`: the port's `placeholder_info` of its proof is
    the JAX package's of the JAX proof (`test_aux_components.py:80`), and
    `print_placeholder_params` prints the same."""
    info = TPROF.placeholder_info(proofs.proof, proofs.pub.common_data)
    assert info == RPROF.placeholder_info(proofs.ref_proof,
                                          proofs.ref_pub.common_data)
    assert info["rows_amount"] == proofs.circuit[2].rows_amount
    assert info["batches"]["0"] > 0 and info["total_opened_values"] > 0
    assert TPROF.print_placeholder_params(proofs.pub.common_data,
                                          proofs.fri) == \
        RPROF.print_placeholder_params(proofs.ref_pub.common_data,
                                       proofs.ref_fri)


# ---------------------------------------------------------------------------
# the entry points and the launcher
# ---------------------------------------------------------------------------

def test_entry_forward_equals_the_reference():
    """`entry.entry` is `__graft_entry__.entry`'s forward step."""
    import __graft_entry__ as GE
    fwd, args = EN.entry(device="cpu")
    ref_fwd, ref_args = GE.entry()
    assert np.array_equal(fwd(*args).numpy(),
                          np.asarray(ref_fwd(*ref_args)).astype(np.int32))


def test_entry_defaults_to_the_card():
    """No CPU fallback: without a card the default device raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EN.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EN.dryrun_multichip(2)


def test_a_failing_rank_fails_the_world():
    """A rank's error stops every rank and is raised with its traceback
    (a length that is not a power of two)."""
    with pytest.raises(RuntimeError, match="rank .* failed"):
        launch.run(2, [(E + "mesh_ntt", {"field": "bls12_381_fr",
                                         "coeffs": [1, 2, 3]})], "cpu",
                   timeout=120)


def test_distributed_msm_refuses_a_nonzero_a_curve():
    """The device MSM's formulas hold for a = 0 curves only: every rank
    refuses an MNT curve before any collective (no world needed)."""
    from crypto3_zk_tpu_torch.fields import mnt as MNT
    from crypto3_zk_tpu_torch.parallel.msm import distributed_msm
    with pytest.raises(ValueError, match="a = 0"):
        distributed_msm(MNT.MNT4, [MNT.MNT4.g1], [1], device="cpu")
