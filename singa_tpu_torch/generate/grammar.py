"""SMILES grammar + valence masking for decoding (counterpart of
``singa_tpu/generate/grammar.py``).

A per-step boolean mask over the vocabulary, computed incrementally from a
compact per-beam grammar state with batched tensor ops and table lookups
(tables built in numpy once). The mask is permissive: it may admit some
invalid SMILES but never excludes a valid continuation. Approximations, all
on the permissive side: on ``(`` the branch pushes ``cur_val - 1``; ring
closures debit only the closing atom; aromatic bonds count as order 1.

State per beam (all int32):
  depth     paren nesting depth
  rings     9-bit mask of open ring-bond digits
  pending   bond order demanded by a just-seen bond token (0 = default single)
  cur_val   remaining valence of the current attachment atom (NONE if none)
  stack     [MAX_DEPTH] saved cur_val values of enclosing attachment atoms
  last      class of the previous token (SOS/ATOM/BOND/OPEN/CLOSE/DIGIT/DOT)
  cur_atom  id of the current attachment atom (-1 none); atom_n the counter;
  astack    [MAX_DEPTH] saved cur_atom per branch; ring_atom [9] the atom
            that opened each ring digit (self-ring closures are pruned)
  cur_arom, ring_cnt, ring_arom, ring_pure  aromatic-ring feasibility
"""
from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SMI_VOCAB, SOS_TOKEN

MAX_DEPTH = 24
NONE_VAL = -99  # cur_val sentinel: no attachment atom (start / after '.')

# token classes
ATOM, BOND, OPEN, CLOSE, DIGIT, DOT, EOS, SOS, PAD = range(9)

_BASE_VALENCE = {
    "B": 3, "C": 4, "N": 5, "O": 2, "F": 1, "P": 5, "S": 6,
    "Cl": 1, "Br": 1, "I": 5, "H": 1, "Si": 4, "Se": 6, "Sn": 4,
    "Sb": 5, "As": 5, "Al": 3,
}
_METAL_VALENCE = 8  # Fe/Zn/Na/K/... — effectively unconstrained

_BRACKET_RE = re.compile(
    r"^\[(?P<iso>\d+)?(?P<el>[A-Z][a-z]?|[a-z]{1,2})(?P<chi>@{1,2})?"
    r"(?P<h>H\d*)?(?P<chg>[+-]+\d*|[+-]\d*)?\]$"
)


def _atom_capacity(tok: str) -> int:
    """Max bonds this atom token can still form, from its SMILES spelling."""
    if not tok.startswith("["):
        el = tok if tok in _BASE_VALENCE else tok.capitalize()  # c -> C
        return _BASE_VALENCE.get(el, _METAL_VALENCE)
    m = _BRACKET_RE.match(tok)
    if m is None:
        return _METAL_VALENCE
    el = m.group("el")
    el_key = el.capitalize() if el.islower() else el
    base = _BASE_VALENCE.get(el_key, _METAL_VALENCE)
    h = m.group("h")
    nh = 0 if h is None else (1 if h == "H" else int(h[1:]))
    chg = m.group("chg") or ""
    charge = 0
    if chg:
        sign = 1 if chg[0] == "+" else -1
        digits = chg.lstrip("+-")
        charge = sign * (int(digits) if digits else len(chg))
    if el_key in ("B", "Al"):
        charge = -charge  # borate-type anions gain a bond ([B-] binds 4)
    return max(base + charge - nh, 1)


def _is_aromatic_token(tok: str) -> bool:
    if tok.startswith("["):
        m = _BRACKET_RE.match(tok)
        el = m.group("el") if m else ""
        return bool(el) and el.islower()
    return tok in ("c", "n", "o", "p", "s")


def _build_tables():
    V = len(SMI_VOCAB)
    cls = np.full(V, ATOM, np.int32)
    cap = np.zeros(V, np.int32)
    order = np.zeros(V, np.int32)
    digit = np.zeros(V, np.int32)
    arom = np.zeros(V, np.int32)
    plain_c = np.zeros(V, np.int32)
    for i, tok in enumerate(SMI_VOCAB):
        if i == SOS_TOKEN:
            cls[i] = SOS
        elif i == EOS_TOKEN:
            cls[i] = EOS
        elif i == PAD_TOKEN:
            cls[i] = PAD
        elif tok == "(":
            cls[i] = OPEN
        elif tok == ")":
            cls[i] = CLOSE
        elif tok == ".":
            cls[i] = DOT
        elif tok in ("-", "/", "\\"):
            cls[i], order[i] = BOND, 1
        elif tok == "=":
            cls[i], order[i] = BOND, 2
        elif tok == "#":
            cls[i], order[i] = BOND, 3
        elif tok.isdigit():
            cls[i], digit[i] = DIGIT, int(tok)
        else:
            cls[i] = ATOM
            cap[i] = _atom_capacity(tok)
            arom[i] = int(_is_aromatic_token(tok))
            plain_c[i] = int(tok == "c")
    return cls, cap, order, digit, arom, plain_c


(TOKEN_CLASS, ATOM_CAPACITY, BOND_ORDER, RING_DIGIT,
 IS_AROMATIC, IS_PLAIN_C) = _build_tables()

_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(globals()[name], dtype=torch.int32, device=device)
    return _TABLES[key]


class GrammarState(NamedTuple):
    depth: torch.Tensor  # [...] int32
    rings: torch.Tensor  # [...] int32 bitmask (bit d-1 = ring digit d open)
    pending: torch.Tensor  # [...] int32, 0 = no explicit bond pending
    cur_val: torch.Tensor  # [...] int32, NONE_VAL = no attachment atom
    stack: torch.Tensor  # [..., MAX_DEPTH] int32
    last: torch.Tensor  # [...] int32 token class
    cur_atom: torch.Tensor  # [...] int32 id of the attachment atom (-1 = none)
    atom_n: torch.Tensor  # [...] int32 atoms emitted so far
    astack: torch.Tensor  # [..., MAX_DEPTH] int32 saved cur_atom per branch
    ring_atom: torch.Tensor  # [..., 9] int32 atom id that opened ring digit d
    cur_arom: torch.Tensor  # [...] int32 current attachment atom is aromatic
    ring_cnt: torch.Tensor  # [..., 9] int32 atoms emitted since digit d opened
    ring_arom: torch.Tensor  # [..., 9] int32 digit d opened on an aromatic atom
    ring_pure: torch.Tensor  # [..., 9] int32 branch-free all-plain-'c' chain so far


def init_state(shape: tuple[int, ...], device=None) -> GrammarState:
    full = lambda s, v: torch.full(s, v, dtype=torch.int32, device=device)
    shape = tuple(shape)
    return GrammarState(
        depth=full(shape, 0),
        rings=full(shape, 0),
        pending=full(shape, 0),
        cur_val=full(shape, NONE_VAL),
        stack=full(shape + (MAX_DEPTH,), 0),
        last=full(shape, SOS),
        cur_atom=full(shape, -1),
        atom_n=full(shape, 0),
        astack=full(shape + (MAX_DEPTH,), -1),
        ring_atom=full(shape + (9,), -2),
        cur_arom=full(shape, 0),
        ring_cnt=full(shape + (9,), 0),
        ring_arom=full(shape + (9,), 0),
        ring_pure=full(shape + (9,), 0),
    )


def _take_last(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [..., D] gathered at vocab-indexed positions idx [V] -> [..., V]."""
    return t.index_select(-1, idx)


def allowed_tokens(state: GrammarState, allow_dot: bool = True, return_forced: bool = False):
    """Boolean mask [..., V] of grammatically admissible next tokens. With
    ``return_forced`` also a [...] flag for beams where nothing was admissible
    and EOS was force-allowed (callers demote them)."""
    dev = state.depth.device
    last = state.last[..., None]
    depth = state.depth[..., None]
    rings = state.rings[..., None]
    cur = state.cur_val[..., None]
    pend = state.pending[..., None]
    eff = torch.clamp(pend, min=1)  # bond order the next atom/digit would consume

    cls = _table("TOKEN_CLASS", dev)
    after_atomish = (last == ATOM) | (last == DIGIT) | (last == CLOSE)
    has_attach = cur > NONE_VAL // 2

    cap_t = _table("ATOM_CAPACITY", dev)
    ok_atom = (
        (cls == ATOM) & (~has_attach | ((cur >= eff) & (cap_t >= eff)))
        & (last != EOS) & (last != PAD)
    )
    ok_bond = (
        (cls == BOND) & (after_atomish | (last == OPEN)) & (pend == 0)
        & (cur >= _table("BOND_ORDER", dev))
    )
    ok_open = (
        (cls == OPEN) & after_atomish & (cur >= 1) & (depth < MAX_DEPTH - 1) & (pend == 0)
    )
    ok_close = (cls == CLOSE) & (depth > 0) & after_atomish & (pend == 0)

    ring_digit = _table("RING_DIGIT", dev)
    bit = torch.where(
        cls == DIGIT, 1 << torch.clamp(ring_digit - 1, min=0), torch.zeros_like(cls)
    )
    is_open = (rings & bit) > 0
    ok_digit = (
        (cls == DIGIT) & ((last == ATOM) | (last == DIGIT) | (last == BOND)) & (cur >= eff)
    )
    didx = torch.clamp(ring_digit - 1, 0, 8).long()  # [V]
    opener = _take_last(state.ring_atom, didx)
    ok_digit = ok_digit & ~(is_open & (opener == state.cur_atom[..., None]))

    # aromatic-ring feasibility (kekulisation rules)
    cnt = _take_last(state.ring_cnt, didx)
    op_arom = _take_last(state.ring_arom, didx) > 0
    pure = _take_last(state.ring_pure, didx) > 0
    arom_closure = is_open & op_arom & (state.cur_arom[..., None] > 0) & (pend == 0)
    bad_size = (cnt < 4) | (pure & ((cnt == 4) | (cnt == 6)))
    ok_digit = ok_digit & ~(arom_closure & bad_size)

    ok_dot = (cls == DOT) & after_atomish & (depth == 0) & (pend == 0) & bool(allow_dot)
    ok_eos = (cls == EOS) & after_atomish & (depth == 0) & (rings == 0) & (pend == 0)

    allowed = ok_atom | ok_bond | ok_open | ok_close | ok_digit | ok_dot | ok_eos
    # an aromatic atom emitted with no ring open must open a ring digit now
    must_ring = (last == ATOM) & (state.cur_arom[..., None] > 0) & (rings == 0)
    allowed = allowed & torch.where(must_ring, cls == DIGIT, torch.ones_like(allowed))
    # safety valve: a beam with nothing admissible may only end
    none_ok = ~allowed.any(dim=-1, keepdim=True)
    out = allowed | (none_ok & (cls == EOS))
    if return_forced:
        return out, none_ok[..., 0]
    return out


def _scatter_set(stack: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """stack[..., idx] = val with batched idx/val."""
    onehot = F.one_hot(idx.long(), stack.shape[-1]).to(stack.dtype)
    return stack * (1 - onehot) + onehot * val[..., None]


def update(state: GrammarState, tok: torch.Tensor) -> GrammarState:
    """Advance the grammar state by one token (``tok`` has the state's shape)."""
    dev = tok.device
    tok = tok.long()
    cls = _table("TOKEN_CLASS", dev)[tok]
    cap = _table("ATOM_CAPACITY", dev)[tok]
    order = _table("BOND_ORDER", dev)[tok]
    dig = _table("RING_DIGIT", dev)[tok]
    eff = torch.clamp(state.pending, min=1)
    i32 = lambda b: b.to(torch.int32)

    is_atom = cls == ATOM
    is_bond = cls == BOND
    is_open = cls == OPEN
    is_close = cls == CLOSE
    is_digit = cls == DIGIT
    is_dot = cls == DOT
    has_attach = state.cur_val > NONE_VAL // 2

    atom_cur = torch.where(has_attach, cap - eff, cap)
    digit_cur = state.cur_val - eff

    new_depth = state.depth + i32(is_open) - i32(is_close)
    bit = torch.where(is_digit, 1 << torch.clamp(dig - 1, min=0), torch.zeros_like(dig))
    new_rings = state.rings ^ bit

    push_idx = torch.clamp(state.depth, 0, MAX_DEPTH - 1)
    pop_idx = torch.clamp(state.depth - 1, 0, MAX_DEPTH - 1)
    pushed = torch.gather(state.stack, -1, pop_idx[..., None].long())[..., 0]
    new_stack = torch.where(
        is_open[..., None],
        _scatter_set(state.stack, push_idx, torch.clamp(state.cur_val - 1, min=0)),
        state.stack,
    )

    new_cur = torch.where(is_atom, atom_cur, state.cur_val)
    new_cur = torch.where(is_digit, digit_cur, new_cur)
    new_cur = torch.where(is_close, pushed, new_cur)
    new_cur = torch.where(is_dot, torch.full_like(new_cur, NONE_VAL), new_cur)

    new_pending = torch.where(is_bond, order, torch.zeros_like(order))

    a_pushed = torch.gather(state.astack, -1, pop_idx[..., None].long())[..., 0]
    new_astack = torch.where(
        is_open[..., None], _scatter_set(state.astack, push_idx, state.cur_atom), state.astack
    )
    new_atom = torch.where(is_atom, state.atom_n, state.cur_atom)
    new_atom = torch.where(is_close, a_pushed, new_atom)
    new_atom = torch.where(is_dot, torch.full_like(new_atom, -1), new_atom)
    new_atom_n = state.atom_n + i32(is_atom)

    opening = is_digit & ((state.rings & bit) == 0)
    slot = F.one_hot(torch.clamp(dig - 1, 0, 8).long(), 9).to(torch.int32)
    fresh = (i32(opening)[..., None] * slot) > 0
    new_ring_atom = torch.where(
        fresh, state.cur_atom[..., None].expand_as(state.ring_atom), state.ring_atom
    )

    tok_arom = (_table("IS_AROMATIC", dev) + _table("IS_PLAIN_C", dev))[tok]
    new_cur_arom = torch.where(is_atom, tok_arom, state.cur_arom)
    new_cur_arom = torch.where(is_dot, torch.zeros_like(new_cur_arom), new_cur_arom)

    shifts = torch.arange(9, dtype=torch.int32, device=dev)
    open_bits = (state.rings[..., None] >> shifts) & 1
    new_ring_cnt = state.ring_cnt + i32(is_atom)[..., None] * open_bits
    impure = (is_open | is_bond)[..., None] | (is_atom[..., None] & (tok_arom[..., None] != 2))
    new_ring_pure = state.ring_pure * (1 - i32(impure))
    new_ring_cnt = torch.where(fresh, torch.zeros_like(new_ring_cnt), new_ring_cnt)
    new_ring_arom = torch.where(
        fresh, i32(state.cur_arom > 0)[..., None].expand_as(state.ring_arom), state.ring_arom
    )
    new_ring_pure = torch.where(
        fresh, i32(state.cur_arom == 2)[..., None].expand_as(new_ring_pure), new_ring_pure
    )

    return GrammarState(
        depth=new_depth,
        rings=new_rings,
        pending=new_pending,
        cur_val=new_cur,
        stack=new_stack,
        last=cls,
        cur_atom=new_atom,
        atom_n=new_atom_n,
        astack=new_astack,
        ring_atom=new_ring_atom,
        cur_arom=new_cur_arom,
        ring_cnt=new_ring_cnt,
        ring_arom=new_ring_arom,
        ring_pure=new_ring_pure,
    )
