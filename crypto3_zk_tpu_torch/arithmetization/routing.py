"""Counterpart of `arithmetization/routing.py` of the JAX package (host
only).

Permutation routing networks (Beneš / AS-Waksman).

`snark/routing/{benes,as_waksman}.hpp` + `zk/math/integer_permutation.hpp`:
switch-network routing for permutation gadgets. The router computes switch
settings for an arbitrary permutation by the classic recursive loop-coloring
construction; `apply_routing` simulates the network, which is the
correctness oracle used by the tests
(`test/routing_algorithms/test_routing_algorithms.cpp:65`).

Representation: a routed network is a nested structure
    ("leaf",)                                   n == 1
    ("switch", bool)                            n == 2
    ("node", in_switches, upper, lower, out_switches, n)
where in_switches / out_switches are lists of bools for pairs (2i, 2i+1)
(the last wire of an odd-sized network goes straight through).
"""
from __future__ import annotations


class IntegerPermutation:
    """`math::integer_permutation` — permutation ADT with inverse/compose."""

    def __init__(self, mapping: list[int]):
        if sorted(mapping) != list(range(len(mapping))):
            raise ValueError("not a permutation")
        self.mapping = list(mapping)

    def __getitem__(self, i: int) -> int:
        return self.mapping[i]

    def __len__(self):
        return len(self.mapping)

    def inverse(self) -> "IntegerPermutation":
        out = [0] * len(self.mapping)
        for i, v in enumerate(self.mapping):
            out[v] = i
        return IntegerPermutation(out)

    def compose(self, other: "IntegerPermutation") -> "IntegerPermutation":
        """self after other: (self.compose(other))[i] = self[other[i]]."""
        return IntegerPermutation([self.mapping[other.mapping[i]]
                                   for i in range(len(self))])

    def is_identity(self) -> bool:
        return all(v == i for i, v in enumerate(self.mapping))


def route(pi: list[int]):
    """AS-Waksman routing of permutation pi (output[pi[i]] = input[i]...
    convention here: wire entering input i must exit at output pi[i])."""
    n = len(pi)
    if sorted(pi) != list(range(n)):
        raise ValueError("not a permutation")
    if n == 1:
        return ("leaf",)
    if n == 2:
        return ("switch", pi[0] == 1)

    half_up = n // 2        # upper subnet size (floor)
    half_lo = n - half_up   # lower subnet size (ceil; extra straight wire)

    # in_sw[i]: switch for inputs (2i, 2i+1); False = straight.
    n_in_sw = n // 2 if n % 2 == 0 else (n - 1) // 2
    in_sw = [None] * n_in_sw
    out_sw = [None] * n_in_sw

    inv = [0] * n
    for i, v in enumerate(pi):
        inv[v] = i

    def in_pair(i):
        return i // 2 if i < 2 * n_in_sw else None

    def out_pair(o):
        return o // 2 if o < 2 * n_in_sw else None

    # sub-destination assignment: color each wire upper(0)/lower(1)
    color = [None] * n      # by input index
    ocolor = [None] * n     # by output index

    def set_input(i, c):
        """Assign input i to subnet c; propagate constraints."""
        stack = [("in", i, c)]
        while stack:
            kind, idx, c = stack.pop()
            if kind == "in":
                if color[idx] is not None:
                    assert color[idx] == c
                    continue
                color[idx] = c
                pr = in_pair(idx)
                if pr is not None:
                    in_sw[pr] = (c == 1) == (idx % 2 == 0)
                    sib = idx ^ 1
                    stack.append(("in", sib, 1 - c))
                # the wire exits at output pi[idx] through subnet c
                stack.append(("out", pi[idx], c))
            else:
                if ocolor[idx] is not None:
                    assert ocolor[idx] == c
                    continue
                ocolor[idx] = c
                pr = out_pair(idx)
                if pr is not None:
                    out_sw[pr] = (c == 1) == (idx % 2 == 0)
                    sib = idx ^ 1
                    stack.append(("out", sib, 1 - c))
                    stack.append(("in", inv[sib], 1 - c))

    if n % 2 == 1:
        # last wire is straight into the LOWER subnet on both sides
        set_input(n - 1, 1)
    else:
        # AS-Waksman: output pair (n-2, n-1) has NO switch: out n-1 goes
        # lower, out n-2 upper. Route them first.
        set_input(inv[n - 1], 1)
        set_input(inv[n - 2], 0)

    for i in range(n):
        if color[i] is None:
            set_input(i, 0)

    # build sub-permutations
    def sub_index_in(i, c):
        """Index of input i within its subnet."""
        cnt = 0
        for j in range(i):
            if color[j] == c:
                cnt += 1
        return cnt

    def sub_index_out(o, c):
        cnt = 0
        for j in range(o):
            if ocolor[j] == c:
                cnt += 1
        return cnt

    subs = {0: {}, 1: {}}
    for i in range(n):
        c = color[i]
        subs[c][sub_index_in(i, c)] = sub_index_out(pi[i], c)
    up_pi = [subs[0][k] for k in range(len(subs[0]))]
    lo_pi = [subs[1][k] for k in range(len(subs[1]))]
    assert len(up_pi) == half_up and len(lo_pi) == half_lo, \
        (len(up_pi), len(lo_pi), half_up, half_lo)

    in_sw = [bool(b) for b in in_sw]
    out_sw_final = []
    for k in range(n_in_sw):
        if n % 2 == 0 and k == n_in_sw - 1:
            out_sw_final.append(False)  # fixed pass-through pair
        else:
            out_sw_final.append(bool(out_sw[k]))
    return ("node", in_sw, route(up_pi), route(lo_pi), out_sw_final, n)


def apply_routing(net, values: list):
    """Simulate the routed network: returns outputs where
    output[pi[i]] = values[i]."""
    if net[0] == "leaf":
        return list(values)
    if net[0] == "switch":
        return [values[1], values[0]] if net[1] else list(values)
    _, in_sw, up, lo, out_sw, n = net
    n_in_sw = len(in_sw)
    upper_in, lower_in = [], []
    for k in range(n_in_sw):
        a, b = values[2 * k], values[2 * k + 1]
        if in_sw[k]:
            a, b = b, a
        upper_in.append(a)
        lower_in.append(b)
    if n % 2 == 1:
        lower_in.append(values[n - 1])
    upper_out = apply_routing(up, upper_in)
    lower_out = apply_routing(lo, lower_in)
    out = [None] * n
    for k in range(n_in_sw):
        a, b = upper_out[k], lower_out[k]
        if out_sw[k]:
            a, b = b, a
        out[2 * k] = a
        out[2 * k + 1] = b
    if n % 2 == 1:
        out[n - 1] = lower_out[-1]
    return out


def benes_route(pi: list[int]):
    """Beneš network routing: power-of-two sizes only
    (`routing/benes.hpp`); same recursive construction."""
    n = len(pi)
    if n & (n - 1):
        raise ValueError("Benes network requires power-of-two size")
    return route(pi)


def as_waksman_route(pi: list[int]):
    """`routing/as_waksman.hpp:102-146`: arbitrary sizes."""
    return route(pi)
