"""The port's Placeholder modules (`models/placeholder/*`,
`arithmetization/plonk.py`, `ops/ntt.py::divide_by_vanishing`,
`arithmetization/circuits.py::placeholder_chain`) against the JAX package's,
module by module, on the CPU at the sizes of `tests/circuits.py`: the same
circuit gives the same transcript hash, the same preprocessed columns, the
same F parts of each argument from the same inputs and transcript, and the
same quotient. Exact equality. The whole proofs are compared in
`test_torch_placeholder_proofs.py` and `test_torch_placeholder_lookup.py`."""
import random
import types

import numpy as np
import torch
import pytest

import circuits as CI
from crypto3_zk_tpu.arithmetization import plonk as RPK
from crypto3_zk_tpu.commitments import batched as RB
from crypto3_zk_tpu.commitments import fri as RFRI
from crypto3_zk_tpu.commitments import lpc as RLPC
from crypto3_zk_tpu.fields import params as P
from crypto3_zk_tpu.models.placeholder import arguments as RA
from crypto3_zk_tpu.models.placeholder import common as RC
from crypto3_zk_tpu.models.placeholder import lookup_argument as RLA
from crypto3_zk_tpu.models.placeholder import preprocessor as RPP
from crypto3_zk_tpu.models.placeholder import verifier as RV
from crypto3_zk_tpu.ops import limbs as RL
from crypto3_zk_tpu.ops import ntt as RN
from crypto3_zk_tpu.poly import domain as RD
from crypto3_zk_tpu.poly.polynomial import PolyDFS as RPolyDFS
from crypto3_zk_tpu.transcript import fiat_shamir as RT
from crypto3_zk_tpu_torch import convert as CV
from crypto3_zk_tpu_torch.arithmetization import circuits as TCI
from crypto3_zk_tpu_torch.arithmetization import plonk as PK
from crypto3_zk_tpu_torch.commitments import fri as FRI
from crypto3_zk_tpu_torch.commitments.lpc import LPCScheme
from crypto3_zk_tpu_torch.fields import params as TP
from crypto3_zk_tpu_torch.models.placeholder import arguments as TA
from crypto3_zk_tpu_torch.models.placeholder import common as TC
from crypto3_zk_tpu_torch.models.placeholder import lookup_argument as TLA
from crypto3_zk_tpu_torch.models.placeholder import preprocessor as TPP
from crypto3_zk_tpu_torch.models.placeholder.prover import prove
from crypto3_zk_tpu_torch.models.placeholder.verifier import verify
from crypto3_zk_tpu_torch.ops import limbs as TL
from crypto3_zk_tpu_torch.ops import ntt as TN
from crypto3_zk_tpu_torch.poly import domain as TD
from crypto3_zk_tpu_torch.tools.placeholder_fixture import PlaceholderRun
from crypto3_zk_tpu_torch.transcript.fiat_shamir import Transcript

import torch_threads  # noqa: F401  one torch thread a worker

RFS, FS = P.BLS12_381_FR, TP.BLS12_381_FR
REF_MODULES = types.SimpleNamespace(common=RC, lpc=RLPC, batched=RB,
                                    fri=RFRI)
SEED = b"placeholder parity"
CIRCUITS = ["circuit_1", "circuit_lookup", "circuit_t", "circuit_3",
            "circuit_4", "circuit_5", "circuit_fib", "circuit_6",
            "circuit_7"]


def _circuit(name, rfs=RFS, seed=0xAB):
    """The reference's circuit and the port's copy of it."""
    cs, asg, desc, pi = getattr(CI, name)(rfs, random.Random(seed))
    return (cs, asg, desc, pi), CV.plonk_from_reference(cs, asg, desc)


def _same_poly(got, want):
    """A port `PolyDFS` equals a reference one: digits and degree bound."""
    assert got.deg == want.deg
    np.testing.assert_array_equal(got.v.numpy(),
                                  np.asarray(want.v).astype(np.int32))


def _ref_common_from_port(common, desc, rfs=RFS):
    """The reference's `CommonData` from the port's (plain values)."""
    return RPP.CommonData(
        vk=RPP.VerificationKey(common.vk.constraint_system_with_params_hash,
                               common.vk.fixed_values_commitment),
        columns_rotations=[list(r) for r in common.columns_rotations],
        desc=desc, max_gates_degree=common.max_gates_degree,
        permutation_parts=common.permutation_parts,
        lookup_parts=common.lookup_parts,
        permuted_columns=list(common.permuted_columns),
        max_quotient_chunks=common.max_quotient_chunks,
        commitment_scheme_data={k: list(v) for k, v in
                                common.commitment_scheme_data.items()},
        basic_domain=RD.get_domain(rfs, common.basic_domain.n))


# ---------------------------------------------------------------------------
# the circuit and its transcript hash
# ---------------------------------------------------------------------------

def test_port_circuit_1_is_the_reference_fixture():
    """The port's own `circuits.circuit_1` (which `chip_smoke.py` proves
    over Goldilocks) is the reference's fixture: the same table for the
    same seed and the same constraint-system hash."""
    (cs, asg, desc, pi), (tcs, tasg, tdesc) = _circuit("circuit_1",
                                                       P.GOLDILOCKS)
    mcs, masg, mdesc, mpi = TCI.circuit_1(TP.GOLDILOCKS.p,
                                          random.Random(0xAB))
    assert vars(masg) == vars(tasg) and vars(mdesc) == vars(tdesc)
    assert mpi == pi
    fri = FRI.FRIParams.build(TP.GOLDILOCKS, degree_log=4, lambda_=4)
    params = TC.PlaceholderParams(TP.GOLDILOCKS)
    assert TC.constraint_system_with_params_hash(
        params, mcs, mdesc, fri.transcript_repr(), TP.GOLDILOCKS.generator) \
        == TC.constraint_system_with_params_hash(
            params, tcs, tdesc, fri.transcript_repr(),
            TP.GOLDILOCKS.generator)


@pytest.mark.parametrize("name", CIRCUITS)
def test_constraint_system_hash_equals_the_reference(name):
    (cs, asg, desc, _), (tcs, tasg, tdesc) = _circuit(name)
    for c, tc in zip([c for g in cs.gates for c in g.constraints],
                     [c for g in tcs.gates for c in g.constraints]):
        assert TC._expr_repr(tc) == RC._expr_repr(c)
        assert PK.expr_max_degree(tc) == RPK.expr_max_degree(c)
    for th in ("keccak_256", "poseidon"):
        ref_fri = RFRI.FRIParams.build(
            RFS, degree_log=desc.rows_amount.bit_length() - 1, lambda_=4,
            merkle_hash="keccak_256", transcript_hash=th)
        fri = CV.fri_params_from_reference(ref_fri.get_params())
        want = RC.constraint_system_with_params_hash(
            RC.PlaceholderParams(RFS, th), cs, desc,
            ref_fri.transcript_repr(), RFS.generator)
        got = TC.constraint_system_with_params_hash(
            TC.PlaceholderParams(FS, th), tcs, tdesc, fri.transcript_repr(),
            FS.generator)
        assert got == want
    assert TPP.columns_rotations(tcs, tdesc) == \
        RPP.columns_rotations(cs, desc)
    assert [(v.type, v.index, v.rotation)
            for v in tcs.permuted_columns(tdesc)] == \
        [(v.type, v.index, v.rotation) for v in cs.permuted_columns(desc)]
    for mqc in (0, 5):
        assert TPP.lookup_parts_list(tcs, mqc) == \
            RPP.lookup_parts_list(cs, mqc)
    assert tcs.lookup_poly_degree_bound() == cs.lookup_poly_degree_bound()
    assert (tcs.max_gates_degree(), tcs.max_lookup_gates_degree()) == \
        (cs.max_gates_degree(), cs.max_lookup_gates_degree())


# ---------------------------------------------------------------------------
# preprocessed columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["circuit_1", "circuit_t", "circuit_5",
                                  "circuit_lookup"])
def test_preprocessed_columns_equal_the_reference(name):
    """S_id, S_sigma (from the copy cycles), q_last and q_blind."""
    (cs, asg, desc, _), (tcs, tasg, tdesc) = _circuit(name)
    delta = RFS.generator
    rdom, tdom = RD.get_domain(RFS, desc.rows_amount), \
        TD.get_domain(FS, desc.rows_amount)
    gi = [desc.global_index(v) for v in cs.permuted_columns(desc)]
    assert gi == [tdesc.global_index(v) for v in tcs.permuted_columns(tdesc)]
    cycles = RPP.CycleRepresentation(cs, desc)
    tcycles = TPP.CycleRepresentation(tcs, tdesc)
    assert tcycles._mapping == cycles._mapping
    pairs = list(zip(
        TPP.identity_polynomials(FS, len(gi), tdom, delta, "cpu"),
        RPP.identity_polynomials(RFS, len(gi), rdom, delta)))
    pairs += zip(
        TPP.permutation_polynomials(FS, gi, tdom, delta, tcycles, "cpu"),
        RPP.permutation_polynomials(RFS, gi, rdom, delta, cycles))
    pairs.append((TPP.lagrange_polynomial(FS, tdom, desc.usable_rows_amount,
                                          "cpu"),
                  RPP.lagrange_polynomial(RFS, rdom, desc.usable_rows_amount)))
    pairs.append((TPP.selector_blind(FS, desc.usable_rows_amount, tdom,
                                     "cpu"),
                  RPP.selector_blind(RFS, desc.usable_rows_amount, rdom)))
    assert len(pairs) == 2 * len(gi) + 2
    for got, want in pairs:
        _same_poly(got, want)


# ---------------------------------------------------------------------------
# the arguments' F parts, from the same inputs and transcript
# ---------------------------------------------------------------------------

class _Batches:
    """A commitment-scheme stand-in for one argument: it keeps what is
    appended and commits to a fixed root."""

    def __init__(self):
        self.polys = {}

    def append_to_batch(self, k, polys):
        self.polys.setdefault(k, []).extend(
            polys if isinstance(polys, list) else [polys])

    def commit(self, k):
        return bytes(32)


def _inputs(name, mqc):
    """Both packages' (params, preprocessed public data, table) for the
    arguments, the port's columns carried from the reference's arrays."""
    (cs, asg, desc, _), (tcs, tasg, tdesc) = _circuit(name)
    fs, n = RFS, desc.rows_amount
    rdom = RD.get_domain(fs, n)
    delta = fs.generator
    gi = [desc.global_index(v) for v in cs.permuted_columns(desc)]

    def cols(cc):
        return [RPolyDFS(fs, RL.encode(fs, c), n) for c in cc]

    rpub = RPP.PublicPreprocessedData(
        public_inputs=cols(asg.public_inputs), constants=cols(asg.constants),
        selectors=cols(asg.selectors),
        permutation_polynomials=RPP.permutation_polynomials(
            fs, gi, rdom, delta, RPP.CycleRepresentation(cs, desc)),
        identity_polynomials=RPP.identity_polynomials(fs, len(gi), rdom,
                                                      delta),
        q_last=RPP.lagrange_polynomial(fs, rdom, desc.usable_rows_amount),
        q_blind=RPP.selector_blind(fs, desc.usable_rows_amount, rdom),
        common_data=RPP.CommonData(
            vk=None, columns_rotations=RPP.columns_rotations(cs, desc),
            desc=desc, max_gates_degree=max(cs.max_gates_degree(),
                                            cs.max_lookup_gates_degree()),
            permutation_parts=RPP.permutation_partitions_num(len(gi), mqc),
            lookup_parts=len(RPP.lookup_parts_list(cs, mqc)),
            permuted_columns=gi, max_quotient_chunks=mqc,
            commitment_scheme_data={}, basic_domain=rdom))
    rtable = RA.PolynomialTable(cols(asg.witnesses), rpub.public_inputs,
                                rpub.constants, rpub.selectors)

    def carry(p):
        return CV.poly_dfs_from_reference(FS, np.asarray(p.v), p.deg, "cpu")

    rc = rpub.common_data
    tpub = TPP.PublicPreprocessedData(
        public_inputs=[carry(p) for p in rpub.public_inputs],
        constants=[carry(p) for p in rpub.constants],
        selectors=[carry(p) for p in rpub.selectors],
        permutation_polynomials=[carry(p)
                                 for p in rpub.permutation_polynomials],
        identity_polynomials=[carry(p) for p in rpub.identity_polynomials],
        q_last=carry(rpub.q_last), q_blind=carry(rpub.q_blind),
        common_data=TPP.CommonData(
            vk=None, columns_rotations=rc.columns_rotations, desc=tdesc,
            max_gates_degree=rc.max_gates_degree,
            permutation_parts=rc.permutation_parts,
            lookup_parts=rc.lookup_parts, permuted_columns=gi,
            max_quotient_chunks=mqc, commitment_scheme_data={},
            basic_domain=TD.get_domain(FS, n)))
    ttable = TA.PolynomialTable([carry(p) for p in rtable.witnesses],
                                tpub.public_inputs, tpub.constants,
                                tpub.selectors)
    return ((RC.PlaceholderParams(fs, max_quotient_chunks=mqc), cs, desc,
             rpub, rtable),
            (TC.PlaceholderParams(FS, max_quotient_chunks=mqc), tcs, tdesc,
             tpub, ttable))


def _same_run(got_F, want_F, got_batches, want_batches, tr, rtr):
    assert len(got_F) == len(want_F)
    for got, want in zip(got_F, want_F):
        _same_poly(got, want)
    assert sorted(got_batches.polys) == sorted(want_batches.polys)
    for k, polys in want_batches.polys.items():
        assert len(got_batches.polys[k]) == len(polys)
        for got, want in zip(got_batches.polys[k], polys):
            _same_poly(got, want)
    assert tr.challenge(FS) == rtr.challenge(RFS)


@pytest.mark.parametrize("name,mqc", [("circuit_1", 0), ("circuit_t", 0),
                                      ("circuit_t", 3)])
def test_permutation_argument_equals_the_reference(name, mqc):
    """F[0..2], V_P and (chunked: 3 columns in parts of 2) the running
    products of the partitions."""
    (rp, cs, desc, rpub, rtable), (tp, tcs, tdesc, tpub, ttable) = \
        _inputs(name, mqc)
    rb, tb = _Batches(), _Batches()
    rtr, tr = RT.Transcript("keccak_256", SEED), Transcript("keccak_256",
                                                            SEED)
    want = RA.permutation_prove_eval(rp, cs, rpub, desc, rtable, rb, rtr)
    got = TA.permutation_prove_eval(tp, tcs, tpub, tdesc, ttable, tb, tr)
    assert len(got.permutation_poly_parts) == tpub.common_data \
        .permutation_parts == (2 if mqc else 1)
    _same_run(got.F_dfs, want.F_dfs, tb, rb, tr, rtr)


@pytest.mark.parametrize("name,mqc", [("circuit_lookup", 0),
                                      ("circuit_6", 0), ("circuit_7", 5)])
def test_lookup_argument_equals_the_reference(name, mqc):
    """F[3..6], the sorted columns, V_L and (several parts) the running
    products."""
    (rp, cs, desc, rpub, rtable), (tp, tcs, tdesc, tpub, ttable) = \
        _inputs(name, mqc)
    rb, tb = _Batches(), _Batches()
    rtr, tr = RT.Transcript("keccak_256", SEED), Transcript("keccak_256",
                                                            SEED)
    want = RLA.lookup_prove_eval(rp, cs, rpub, desc, rtable, rb, rtr)
    got = TLA.lookup_prove_eval(tp, tcs, tpub, tdesc, ttable, tb, tr)
    assert got.lookup_commitment == want.lookup_commitment
    assert (len(tb.polys[TC.PERMUTATION_BATCH]) > 1) == (mqc != 0)
    _same_run(got.F_dfs, want.F_dfs, tb, rb, tr, rtr)


@pytest.mark.parametrize("name", ["circuit_1", "circuit_t", "circuit_fib",
                                  "circuit_7"])
def test_gates_argument_equals_the_reference(name):
    """F[7]: degree buckets, rotations, selectors and the mask."""
    (rp, cs, desc, rpub, rtable), (tp, tcs, tdesc, tpub, ttable) = \
        _inputs(name, 0)
    rtr, tr = RT.Transcript("keccak_256", SEED), Transcript("keccak_256",
                                                            SEED)
    n = desc.rows_amount
    rmask = RPolyDFS.constant(RFS, 1, n) - rpub.q_last - rpub.q_blind
    tmask = TA.PolyDFS.constant(FS, 1, n, "cpu") - tpub.q_last - tpub.q_blind
    _same_poly(tmask, rmask)
    want = RA.gates_prove_eval(rp, cs, rtable, rpub.common_data.basic_domain,
                               rpub.common_data.max_gates_degree, rmask, rtr)
    got = TA.gates_prove_eval(tp, tcs, ttable, tpub.common_data.basic_domain,
                              tpub.common_data.max_gates_degree, tmask, tr)
    _same_run([got], [want], _Batches(), _Batches(), tr, rtr)


# ---------------------------------------------------------------------------
# the quotient's division
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,t_len", [(4, 16, 12), (16, 64, 40),
                                       (8, 32, 8)])
def test_divide_by_vanishing_equals_long_division_and_the_reference(
        n, m, t_len):
    rng = random.Random(n * m)
    p = FS.p
    t = [rng.randrange(p) for _ in range(t_len)]
    f = [0] * m                                   # f = t (x^n - 1)
    for i, c in enumerate(t):
        f[i] = (f[i] - c) % p
        f[i + n] = (f[i + n] + c) % p
    got = TN.divide_by_vanishing(FS, TL.encode(FS, f, "cpu"), n)
    assert TL.decode(FS, got) == t + [0] * (m - t_len)
    want = RN.divide_by_vanishing(RFS, RL.encode(RFS, f), n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))


# ---------------------------------------------------------------------------
# the smoke's circuit, built by both packages' classes
# ---------------------------------------------------------------------------

def test_placeholder_chain_agrees_across_packages():
    """`placeholder_chain` at 2^5 rows (table of 4) built with the JAX
    package's classes equals the port's build; the port's proof of it is
    accepted by both verifiers, and a wrong public input by neither."""
    ref = TCI.placeholder_chain(FS.p, 26, random.Random(5), 2, PK=RPK)
    got = TCI.placeholder_chain(FS.p, 26, random.Random(5), 2)
    cs, asg, desc = CV.plonk_from_reference(*ref[:3])
    tcs, tasg, tdesc, tpi = got
    assert (cs.gates, cs.copy_constraints, cs.lookup_gates,
            cs.lookup_tables, cs.public_input_sizes) == \
        (tcs.gates, tcs.copy_constraints, tcs.lookup_gates,
         tcs.lookup_tables, tcs.public_input_sizes)
    assert vars(asg) == vars(tasg) and desc == tdesc and ref[3] == tpi
    assert (tdesc.rows_amount, len(tcs.copy_constraints)) == (32, 26)
    assert sum(tasg.selectors[3]) == 26 - 1 - 5
    assert all(v < 4 for v, s in zip(tasg.witnesses[3], tasg.selectors[3])
               if s)

    run = PlaceholderRun(5, "cpu", lambda_=4, table_bits=2,
                         merkle_hash="keccak_256", seed=5)
    run.preprocess()
    proof, challenge = run.prove()
    assert run.verify(proof) == (True, challenge)
    assert not run.verify(proof, [[run.public_input[0][0] + 1]])[0]
    rcs, rasg, rdesc, rpi = ref
    ref_common = _ref_common_from_port(run.public.common_data, rdesc)
    rproof = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(proof), REF_MODULES)
    rparams = RC.PlaceholderParams(RFS)
    rfri = RFRI.FRIParams.build(RFS, degree_log=5, lambda_=4,
                                merkle_hash="keccak_256")
    assert RV.verify(rparams, ref_common, rproof, rdesc, rcs,
                     RLPC.LPCScheme(rfri), public_input=rpi)
    assert not RV.verify(rparams, ref_common, rproof, rdesc, rcs,
                         RLPC.LPCScheme(rfri), public_input=[[rpi[0][0] + 1]])


# ---------------------------------------------------------------------------
# other fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["PALLAS_FR", "GOLDILOCKS"])
def test_other_fields_prove_and_verify(field):
    """circuit_1 over the Pallas scalar field and over Goldilocks (keccak
    trees): the port's proof verifies in both packages. Both fields have
    kernel instances (Goldilocks the 2-word one, whose p fills its top
    word); where a card is present the proof is made there too and equals
    the CPU's, challenge by challenge (`chip_smoke.py` does so with
    Poseidon trees)."""
    rfs, fs = getattr(P, field), getattr(TP, field)
    (cs, asg, desc, pi), (tcs, tasg, tdesc) = _circuit("circuit_1", rfs)
    fri = FRI.FRIParams.build(fs, degree_log=4, lambda_=4,
                              merkle_hash="keccak_256")
    params = TC.PlaceholderParams(fs)

    def proof_on(device):
        scheme = LPCScheme(fri)
        pub = TPP.process_public(params, tcs, tasg, tdesc, scheme,
                                 device=device)
        priv = TPP.process_private(params, tcs, tasg, tdesc, device=device)
        return pub, prove(params, pub, priv, tdesc, tcs, scheme,
                          device=device)

    pub, proof = proof_on("cpu")
    if torch.cuda.is_available():
        assert CV.placeholder_proof_as_plain(proof_on("cuda")[1]) == \
            CV.placeholder_proof_as_plain(proof)
    assert verify(params, pub.common_data, proof, tdesc, tcs, LPCScheme(fri),
                  public_input=pi)
    rproof = CV.placeholder_proof_from_fields(
        CV.placeholder_proof_fields(proof), REF_MODULES)
    rfri = RFRI.FRIParams.build(rfs, degree_log=4, lambda_=4,
                                merkle_hash="keccak_256")
    assert RV.verify(RC.PlaceholderParams(rfs),
                     _ref_common_from_port(pub.common_data, desc, rfs),
                     rproof, desc, cs, RLPC.LPCScheme(rfri), public_input=pi)
