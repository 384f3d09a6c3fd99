"""Bit lists: the set parameters of every parity mask of a rung, for the
bit-sliced front end of the wide kernels and the small f32 kernel
(``kernels/csrc/bitsliced.cuh``), and that front end's plain numpy version.

A parity is ``x . mask mod 2``. The wide kernels take 128 shots a block, in
four groups of 32, turn their rows into bit planes (plane ``p`` holds
parameter ``p`` of the shots, one shot a bit, one word a group; plane ``P``
is all zero) and form a mask's parity for all of them as the XOR of the
planes of its set parameters. A thread owns a graph and walks the stream
built here, which ends the rung's table buffer
(``sample_tables.table_layout``, ``exact_tables.exact_table_layout``):

* ``bs_base`` (R + 3,): the first word of each row's slot in ``bs_words``,
  then the stream's length S, then the most live half-pi rows and the most
  live pi-product terms any graph has;
* ``bs_meta`` (R, G): ``count | aux << 16`` per row and graph;
* ``bs_words`` (S + AHEAD, G): row ``r`` of graph ``g`` has its parameter indices,
  ascending, in the words ``bs_words[bs_base[r] : bs_base[r + 1], g]``, four
  one-byte indices a word, lowest byte first (two of two bytes from 256
  parameters on, :func:`index_bytes`). Every graph's slot for a row is as
  long as the row's longest list; shorter lists are padded with the index
  ``P`` of the zero plane. The walk therefore has the same shape for every
  graph. AHEAD padding words end the stream.

The R = T1 + T2 + 2 T3 + 2 T4 rows, in order: the node-phase rows (a row past
its graph's count is empty); the half-pi rows, ``aux`` their coefficient mod
8; the pi-product terms, two rows each (psi, phi), ``aux`` the side's
constant; the phase-pair terms, two rows each (alpha, beta). Node phases and
phase pairs keep the order of the tables, because their factors are applied
in that order. The half-pi rows and pi-product terms only accumulate (a sum
mod 8, an XOR), so each graph's are sorted by falling weight, a pi-product
term's heavier side first, dead ones last with empty lists and ``aux`` 0:
rows of like rank then have like weight across the graphs, which keeps the
padding small, and the dead tail is never walked. A half-pi row is dead if
its coefficient is 0 mod 8 or its mask empty; a pi-product term if one side
has an empty mask and constant 0.
"""

from __future__ import annotations

import numpy as np
import torch

SHOTS = 32  # shots per plane word
AHEAD = 4  # padding words that end the stream: the kernels load that far ahead (bitsliced.cuh::kAhead)
MAX_PARAMS = (1 << 16) - 1  # the zero plane's index P fits two bytes


def index_bytes(n_params: int) -> int:
    """Bytes of a parameter index: one while ``P`` and the zero plane's index
    ``P`` fit a byte (``bitsliced.cuh::index_bytes`` is the same rule)."""
    return 1 if n_params < 256 else 2


def bit_list_layout(t1: int, t2: int, t3: int, t4: int, g: int, list_words: int) -> list:
    """The list segments, ``(name, shape, kind)`` in storage order;
    ``list_words`` is the stream's length S in words a graph."""
    r = t1 + t2 + 2 * t3 + 2 * t4
    return [
        ("bs_base", (r + 3,), "i32"),
        ("bs_meta", (r, g), "i32"),
        ("bs_words", (list_words + AHEAD, g), "i32"),
    ]


def _sorted_rows(weight: np.ndarray, live: np.ndarray) -> np.ndarray:
    """(T, G) order: each graph's rows by falling ``weight``, dead rows last,
    ties in table order."""
    key = np.where(live, weight.astype(np.int64), -1)
    return np.argsort(-key, axis=0, kind="stable")


def ordered_rows(circuit) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The rung's parity rows in list order: masks (R, G, P) uint8, aux (R, G)
    int32 and live lengths (2, G) int32 (see the module docstring)."""
    np_f, hp, pp, qp = (
        circuit.node_phases, circuit.halfpi_phases, circuit.pi_products, circuit.phase_pairs,
    )
    G, P = int(circuit.num_graphs), int(circuit.n_params)

    def bits(a):
        a = np.asarray(a, np.uint8) & 1
        return a.reshape(a.shape[0], G, P)

    def ints(a, mask):
        a = np.asarray(a, np.int64) & mask
        return a.reshape(a.shape[0], G)

    def under(counts, t):
        return np.arange(t)[:, None] < np.asarray(counts, np.int64).reshape(1, G)

    def interleave(a, b):
        return np.stack([a, b], axis=1).reshape((2 * a.shape[0],) + a.shape[1:])

    along = np.take_along_axis

    node = bits(np_f.params)
    node = node * under(np_f.counts, node.shape[0])[..., None]

    hp_m = bits(hp.params)
    coeff = ints(hp.coeffs, 7)
    hp_live = (coeff != 0) & hp_m.any(axis=2)
    order = _sorted_rows(hp_m.sum(axis=2), hp_live)
    hp_live = along(hp_live, order, 0)
    hp_m = along(hp_m, order[..., None], 0) * hp_live[..., None]
    hp_aux = along(coeff, order, 0) * hp_live

    psi, phi = bits(pp.psi_params), bits(pp.phi_params)
    pc = ints(pp.psi_const, 1)
    qc = ints(pp.phi_const, 1)
    w_psi, w_phi = psi.sum(axis=2), phi.sum(axis=2)
    pp_live = ((pc != 0) | (w_psi != 0)) & ((qc != 0) | (w_phi != 0))
    swap = w_phi > w_psi  # psi & phi is symmetric: the heavier side goes first
    first = np.where(swap[..., None], phi, psi)
    second = np.where(swap[..., None], psi, phi)
    c_first, c_second = np.where(swap, qc, pc), np.where(swap, pc, qc)
    heavy, light = np.maximum(w_psi, w_phi), np.minimum(w_psi, w_phi)
    order = _sorted_rows(heavy * (P + 1) + light, pp_live)
    pp_live = along(pp_live, order, 0)
    first = along(first, order[..., None], 0) * pp_live[..., None]
    second = along(second, order[..., None], 0) * pp_live[..., None]
    c_first = along(c_first, order, 0) * pp_live
    c_second = along(c_second, order, 0) * pp_live

    alpha, beta = bits(qp.alpha_params), bits(qp.beta_params)
    live4 = under(qp.counts, alpha.shape[0])[..., None]
    pairs = interleave(alpha * live4, beta * live4)

    def no_aux(a):
        return np.zeros(a.shape[:2], np.int64)

    masks = np.concatenate([node, hp_m, interleave(first, second), pairs]).astype(np.uint8)
    aux = np.concatenate([no_aux(node), hp_aux, interleave(c_first, c_second), no_aux(pairs)])
    lengths = np.stack([hp_live.sum(axis=0), pp_live.sum(axis=0)])
    return masks, aux.astype(np.int32), lengths.astype(np.int32)


def build_bit_lists(circuit) -> dict:
    """Named numpy list segments of one rung (see :func:`bit_list_layout`)."""
    return pack_lists(*ordered_rows(circuit))


def pack_lists(masks: np.ndarray, aux: np.ndarray, lengths: np.ndarray) -> dict:
    """The list segments of rows in list order: masks (R, G, P) 0/1, aux (R,
    G) and the live lengths (2, G) of :func:`ordered_rows`."""
    R, G, P = masks.shape
    if P > MAX_PARAMS:
        raise ValueError(f"{P} parameters: the bit lists index at most {MAX_PARAMS}")
    nbytes = index_bytes(P)
    per_word = 4 // nbytes
    counts = masks.sum(axis=2, dtype=np.int64)  # (R, G)
    slot_words = -(-counts.max(axis=1, initial=0) // per_word)  # (R,)
    base = np.concatenate([[0], np.cumsum(slot_words)]).astype(np.int64)
    entries = np.full(((int(base[-1]) + AHEAD) * per_word, G), P, np.int64)
    for r in np.flatnonzero(slot_words):
        # A stable sort of "not set" lists the set parameters first, ascending.
        n = slot_words[r] * per_word
        first = np.argsort(masks[r] == 0, axis=1, kind="stable")[:, :n]
        first = np.pad(first, ((0, 0), (0, n - first.shape[1])))
        first = np.where(np.arange(n)[None, :] < counts[r][:, None], first, P)
        entries[base[r] * per_word : base[r + 1] * per_word] = first.T
    shifts = 8 * nbytes * np.arange(per_word, dtype=np.int64)
    words = (entries.reshape(entries.shape[0] // per_word, per_word, G) << shifts[None, :, None]).sum(axis=1)
    return dict(
        bs_base=np.concatenate([base, lengths.max(axis=1, initial=0)]).astype(np.int32),
        bs_meta=(counts | (aux.astype(np.int64) << 16)).astype(np.int32),
        bs_words=words.astype(np.uint32).view(np.int32),
    )


def flatten_segment(a: np.ndarray, kind: str) -> np.ndarray:
    """One segment as the int32 words it takes in a table buffer."""
    dtype = np.float32 if kind == "f32" else np.int32
    return np.ascontiguousarray(a, dtype).view(np.int32).ravel()


def view_segment(words: torch.Tensor, shape, kind: str) -> torch.Tensor:
    """A tensor view of one segment's int32 ``words``: f32 segments as
    float32, the rest as stored."""
    if kind == "f32":
        words = words.view(torch.float32)
    return words.reshape(shape)


def row_entries(lists: dict, n_params: int, row: int) -> np.ndarray:
    """(slot entries, G) parameter indices of row ``row``'s slot, padding
    (``n_params``) included, unpacked from the stream's words."""
    base, words = np.asarray(lists["bs_base"]), np.asarray(lists["bs_words"])
    nbytes = index_bytes(n_params)
    per_word = 4 // nbytes
    slot = words[base[row] : base[row + 1]].view(np.uint32).astype(np.int64)  # (words, G)
    shifts = 8 * nbytes * np.arange(per_word, dtype=np.int64)
    entries = (slot[:, None, :] >> shifts[None, :, None]) & ((1 << (8 * nbytes)) - 1)
    return entries.reshape(-1, slot.shape[1])


# ------------------------------------------------- the plain front end

def pack_planes(x: np.ndarray) -> np.ndarray:
    """(B, P) 0/1 rows -> (ceil(B / 32), P) uint32 planes: bit s of plane
    [j, p] is parameter p of shot 32 j + s, 0 past the batch's end."""
    x = np.asarray(x, np.uint8) & 1
    B, P = x.shape
    blocks = -(-B // SHOTS)
    padded = np.zeros((blocks * SHOTS, P), np.uint64)
    padded[:B] = x
    weights = np.uint64(1) << np.arange(SHOTS, dtype=np.uint64)
    return (padded.reshape(blocks, SHOTS, P) * weights[None, :, None]).sum(axis=1).astype(np.uint32)


def unpack_shots(words: np.ndarray, batch: int) -> np.ndarray:
    """(blocks, ...) uint32 words -> (batch, ...) 0/1: bit s of block j is shot 32 j + s."""
    shifts = np.arange(SHOTS, dtype=np.uint32).reshape((1, SHOTS) + (1,) * (words.ndim - 1))
    bits = (words[:, None] >> shifts) & np.uint32(1)
    return bits.reshape((words.shape[0] * SHOTS,) + words.shape[1:])[:batch].astype(np.uint8)


def ripple_add(tot: list, w: np.ndarray, c: np.ndarray) -> None:
    """tot += c * w mod 8 for every shot: ``tot`` three bit planes, ``c`` in
    [0, 8) per graph, ``w`` a parity word per block and graph."""
    full = np.uint32(0xFFFFFFFF)
    a0, a1, a2 = (np.where((c >> k) & 1, full, np.uint32(0)) & w for k in range(3))
    c0 = tot[0] & a0
    c1 = (tot[1] & a1) | (c0 & (tot[1] ^ a1))
    tot[0] ^= a0
    tot[1] ^= a1 ^ c0
    tot[2] ^= a2 ^ c1


def sliced_front_end(lists: dict, dims: tuple, x: np.ndarray) -> dict:
    """What the kernels' integer stage computes, in numpy, unpacked per shot:
    a parity word per list row, then the half-pi rows folded into the total's
    bit planes and the pi-product rows into the sign. The wide kernels do that
    a thread a graph, the small f32 kernel a thread a row and then a thread a
    word.

    ``lists`` holds the numpy list segments, ``dims = (T1, T2, T3, T4)``,
    ``x`` (B, P) 0/1 rows. Returns per-shot arrays: ``node`` (B, T1, G),
    ``alpha`` and ``beta`` (B, T4, G) parities, ``tot`` (B, G) the half-pi
    total mod 8 and ``sign`` (B, G) the pi-product sign bit.
    """
    t1, t2, t3, t4 = dims
    base, meta = np.asarray(lists["bs_base"]), np.asarray(lists["bs_meta"])
    R, G = meta.shape
    B, P = x.shape
    planes = pack_planes(x)  # (blocks, P)
    blocks = planes.shape[0]
    planes = np.concatenate([planes, np.zeros((blocks, 1), np.uint32)], axis=1)  # the zero plane
    full = np.uint32(0xFFFFFFFF)

    def row_word(r):
        word = np.zeros((blocks, G), np.uint32)
        for entry in row_entries(lists, P, r):  # (G,) one index a graph, padding included
            word ^= planes[:, entry]
        return word, meta[r] >> 16

    def rows(first, n):
        return np.stack([row_word(first + j)[0] for j in range(n)]) if n else np.zeros((0, blocks, G), np.uint32)

    node = rows(0, t1)
    tot = [np.zeros((blocks, G), np.uint32) for _ in range(3)]
    for r in range(base[R + 1]):
        w, coeff = row_word(t1 + r)
        ripple_add(tot, w, coeff)
    sgn = np.zeros((blocks, G), np.uint32)
    for r in range(base[R + 2]):
        p, pc = row_word(t1 + t2 + 2 * r)
        q, qc = row_word(t1 + t2 + 2 * r + 1)
        sgn ^= (p ^ np.where(pc & 1, full, np.uint32(0))) & (q ^ np.where(qc & 1, full, np.uint32(0)))
    pairs = rows(t1 + t2 + 2 * t3, 2 * t4)
    shot_tot = sum(unpack_shots(t, B).astype(np.int32) << k for k, t in enumerate(tot))
    return dict(
        node=unpack_shots(node.transpose(1, 0, 2), B),
        alpha=unpack_shots(pairs[0::2].transpose(1, 0, 2), B),
        beta=unpack_shots(pairs[1::2].transpose(1, 0, 2), B),
        tot=shot_tot,
        sign=unpack_shots(sgn, B),
    )
