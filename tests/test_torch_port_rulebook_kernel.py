"""Kernels B1a, B1b and B2's formulation held to the JAX package's builders.

``cpd_tpu_torch/ops/rulebook.py`` restates the kernels in PyTorch (their
plain versions, the CPU path of its wrappers): row-padded occupancy words,
the inclusive prefix and the popcount rank, the receptive-field OR and rank
compaction with truncation of the output table. This file holds it, and the
plain twins of ``ops/sparse.py`` (``searchsorted`` and ``unique``), bit-equal
to the JAX package on seeded keys:

* the stage table against ``build_padded_bitmap``;
* the submanifold, strided and inverse rulebooks against
  ``build_subm_rulebook_batched``, ``build_conv_rulebook_batched`` and
  ``build_inverse_rulebook_batched`` (all on their bitmap path: the grids are
  under ``DENSE_LUT_MAX_CELLS``), and the truncated output table against
  ``build_padded_bitmap`` of JAX's output keys;
* the branch's loop on stage tables (``backbone3d._branch_rulebooks`` with
  ``tables=True``, the CUDA path) and ``build_branch_rulebooks`` on CPU keys
  (the twins) against ``cpd_tpu/models/backbone3d.py``'s, sparse and dense
  tail, with and without transposes, and the light branch
  (``with_conv_out=False``).

Integers exactly: ``found``, ``idx`` where found (JAX sets the centre tap of
an invalid row to its row), ``out_keys``, ``out_valid``, the words. The
cases: x extents 13, 32, 33 and 70 (padding bits in a row's last word, and
none); batch 1 and 3, with samples of different counts, an empty sample and
one with no padding slot; keys on the grid's faces and corners (negative
tap origins where the padding is 1 and o = 0); down2, down4 (padding (1, 1,
0)) and conv_out (kernel (1, 1, 3), stride (1, 1, 2), K = 3); caps above and
below the occupancy, and the next stage's table after truncation.

The JAX side is the committed ``tests/torch_port_refs/rulebook_kernel.npz``
(found bits packed, idx kept where found); the ``slow`` test recomputes it
from live JAX (about 3 minutes of jit compiles) and checks there that the
JAX branch's other variants give the same books as the full one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.models import backbone3d as jbb
from cpd_tpu.ops import sparse as jsparse
from cpd_tpu_torch.models import backbone3d
from cpd_tpu_torch.ops import rulebook, sparse
from tests import torch_port_refs as refs
from tests.torch_port_refs import one_torch_thread  # noqa: F401

REF = "rulebook_kernel"
INVALID_KEY = sparse.INVALID_KEY
X_EXTENTS = (13, 32, 33, 70)
NY, NZ = 9, 7
CAP = 320
# batch 3: a sample with no padding slot, an empty one, one half full; batch 1
COUNTS = {3: (CAP, 0, CAP // 2), 1: (CAP - 37,)}
GEOMETRIES = {"down2": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
              "down4": ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
              "conv_out": ((1, 1, 3), (1, 1, 2), (0, 0, 0))}
# (geometry, out cap): above the largest sample's occupancy, and below it
CONVS = (("down2", 4 * CAP), ("down2", 90), ("down4", 60), ("conv_out", 4 * CAP))
BRANCH_GRID = (70, 36, 41)
BRANCH_COUNTS = (1500, 900, 0)
BRANCH_CAPS = (3000, 500, 300, 60)  # down2 binds on sample 0 only
BRANCH_VARIANTS = {"sparse": {}, "sparse_T": {"with_transpose": True},
                   "dense": {"dense_tail": True},
                   "dense_T": {"dense_tail": True, "with_transpose": True},
                   "light_T": {"with_transpose": True, "with_conv_out": False}}
CASES = [(nx, b) for nx in X_EXTENTS for b in COUNTS]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _keys(grid, counts, cap):
    """(B, cap) sorted unique keys, ``counts`` a sample: the grid's 8
    corners and some face cells first, then random cells; INVALID_KEY
    padding."""
    rng = np.random.default_rng(1000 * grid.nx + 10 * len(counts) + cap % 7)
    out = np.full((len(counts), cap), INVALID_KEY, np.int32)
    ends = [(z, y, x) for z in (0, grid.nz - 1) for y in (0, grid.ny - 1)
            for x in (0, grid.nx - 1)]
    ends += [(0, 1, grid.nx // 2), (grid.nz // 2, 0, 1), (1, grid.ny // 2, 0),
             (grid.nz - 1, grid.ny // 2, grid.nx - 2)]
    forced = np.unique([(z * grid.ny + y) * grid.nx + x for z, y, x in ends])
    rest = np.setdiff1d(np.arange(grid.num_cells), forced)
    for b, n in enumerate(counts):
        if n:
            pick = rng.choice(rest, n - len(forced), replace=False)
            out[b, :n] = np.sort(np.concatenate([forced, pick]))
    return out


def case_keys(nx, batch):
    return _keys(sparse.GridSpec(nx, NY, NZ), COUNTS[batch], CAP)


def branch_keys():
    return _keys(sparse.GridSpec(*BRANCH_GRID), BRANCH_COUNTS, max(BRANCH_COUNTS))


def _book_tree(rb):
    found = np.asarray(rb.found)
    idx = np.asarray(rb.idx)[found]
    assert idx.max(initial=0) < 2**15
    return {"found": np.packbits(found), "idx": idx.astype(np.int16),
            "out_keys": np.asarray(rb.out_keys), "out_valid": np.asarray(rb.out_valid)}


def _padded_words(keys, grid):
    """JAX's row-padded words of each sample, as int32 bits (B, words)."""
    words = [np.asarray(jsparse.build_padded_bitmap(jnp.asarray(k), grid)).reshape(-1)
             for k in keys]
    return np.stack(words).view(np.int32)


def jax_reference():
    """The JAX side of every test of this file, from live JAX."""
    tree = {"cases": {}}
    for nx, b in CASES:
        grid = jsparse.GridSpec(nx, NY, NZ)
        keys = case_keys(nx, b)
        jk = jnp.asarray(keys)
        case = {"words": _padded_words(keys, grid),
                "subm": _book_tree(jsparse.build_subm_rulebook_batched(jk, grid))}
        for name, cap in CONVS:
            geom = GEOMETRIES[name]
            rb, out_grid = jsparse.build_conv_rulebook_batched(jk, grid, *geom, cap)
            inv = jsparse.build_inverse_rulebook_batched(jk, rb.out_keys, grid, out_grid, *geom)
            case[f"{name}_{cap}"] = {"conv": _book_tree(rb), "inverse": _book_tree(inv),
                                     "out_words": _padded_words(np.asarray(rb.out_keys),
                                                                out_grid)}
        tree["cases"][f"{nx}_{b}"] = case
    grid = jsparse.GridSpec(*BRANCH_GRID)
    keys = jnp.asarray(branch_keys())
    full = jax.jit(lambda k: jbb.build_branch_rulebooks(k, grid, BRANCH_CAPS,
                                                        with_transpose=True))(keys)
    for kw in BRANCH_VARIANTS.values():
        if kw == {"with_transpose": True}:
            continue
        books = jax.jit(lambda k: jbb.build_branch_rulebooks(k, grid, BRANCH_CAPS, **kw))(keys)
        for name, rb in books.items():  # every variant's books are the full set's
            for a, b in zip(rb, full[name]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    tree["branch"] = {name: _book_tree(rb) for name, rb in full.items()}
    return tree


@pytest.fixture(scope="module")
def ref():
    return refs.load(REF)


def assert_book(port, want, what):
    """A port Rulebook equal to a stored one: found, idx where found,
    out_keys, out_valid."""
    found = port.found.numpy()
    np.testing.assert_array_equal(np.packbits(found), want["found"], err_msg=f"{what}: found")
    np.testing.assert_array_equal(port.idx.numpy()[found], want["idx"], err_msg=f"{what}: idx")
    np.testing.assert_array_equal(port.out_keys.numpy(), want["out_keys"],
                                  err_msg=f"{what}: out_keys")
    np.testing.assert_array_equal(port.out_valid.numpy(), want["out_valid"],
                                  err_msg=f"{what}: out_valid")


def test_popcount_counts_the_low_32_bits():
    rng = np.random.default_rng(0)
    x = rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, INVALID_KEY, -2**31]
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x], np.int32)
    np.testing.assert_array_equal(rulebook.popcount(_t(x)).numpy(), want)


@pytest.mark.parametrize("nx,batch", CASES)
def test_stage_table_holds_jax_padded_bitmap(ref, nx, batch):
    """B1a's plain version: JAX's row-padded words bit for bit (no padding
    bit set), and the inclusive prefix of their popcounts."""
    keys = _t(case_keys(nx, batch))
    grid = sparse.GridSpec(nx, NY, NZ)
    table = rulebook.stage_table(keys, grid)
    want = ref["cases"][f"{nx}_{batch}"]["words"]
    np.testing.assert_array_equal(table.words.numpy(), want)
    counts = np.array([[bin(int(w) & 0xFFFFFFFF).count("1") for w in row] for row in want])
    np.testing.assert_array_equal(table.prefix.numpy(), np.cumsum(counts, -1))
    assert table.words.shape == (batch, NZ * NY * -(-nx // 32))


@pytest.mark.parametrize("nx,batch", CASES)
def test_subm_rulebook_from_the_table_holds_jax_and_the_twin(ref, nx, batch):
    keys = _t(case_keys(nx, batch))
    grid = sparse.GridSpec(nx, NY, NZ)
    want = ref["cases"][f"{nx}_{batch}"]["subm"]
    launches = rulebook.lookup_taps.launches
    assert_book(rulebook.subm_rulebook(keys, rulebook.stage_table(keys, grid)), want, "table")
    assert_book(sparse.build_subm_rulebook_batched(keys, grid), want, "twin")
    assert rulebook.lookup_taps.launches == launches  # CPU tensors launch nothing


@pytest.mark.parametrize("nx,batch", CASES)
def test_strided_and_inverse_rulebooks_hold_jax_and_the_twins(ref, nx, batch):
    """B2's output set and truncated table, and B1b's strided and inverse
    lookups, on every geometry and cap; the output table equals JAX's padded
    bitmap of its (truncated) output keys, and B1a's table of them."""
    keys = _t(case_keys(nx, batch))
    grid = sparse.GridSpec(nx, NY, NZ)
    table = rulebook.stage_table(keys, grid)
    for name, cap in CONVS:
        geom = GEOMETRIES[name]
        want = ref["cases"][f"{nx}_{batch}"][f"{name}_{cap}"]
        what = f"{name} cap {cap}"
        book, out_table = rulebook.conv_rulebook(table, *geom, cap)
        assert_book(book, want["conv"], f"{what}, table")
        twin, out_grid = sparse.build_conv_rulebook_batched(keys, grid, *geom, cap)
        assert_book(twin, want["conv"], f"{what}, twin")
        assert out_table.grid == out_grid
        np.testing.assert_array_equal(out_table.words.numpy(), want["out_words"], err_msg=what)
        again = rulebook.stage_table(book.out_keys, out_grid)
        assert torch.equal(out_table.prefix, again.prefix), what
        inv = rulebook.inverse_rulebook(keys, grid, out_table, *geom)
        assert_book(inv, want["inverse"], f"{what}, inverse from the table")
        assert_book(sparse.build_inverse_rulebook_batched(keys, twin.out_keys, grid, out_grid,
                                                          *geom),
                    want["inverse"], f"{what}, inverse twin")
    below = ref["cases"][f"{nx}_{batch}"]["down2_90"]["conv"]["out_valid"]
    assert below.sum(-1).max() == 90  # the cap binds


@pytest.mark.parametrize("variant", sorted(BRANCH_VARIANTS))
def test_branch_rulebooks_hold_jax(ref, variant):
    """The branch's loop on stage tables (one B1a, a B2 a strided conv, a
    B1b a book: the CUDA path, here on the kernels' plain versions) and
    ``build_branch_rulebooks`` on CPU keys (the plain twins) against the JAX
    branch; a submanifold transpose is the flipped copy (implicit in JAX)."""
    kw = BRANCH_VARIANTS[variant]
    keys = _t(branch_keys())
    grid = sparse.GridSpec(*BRANCH_GRID)
    counts = (rulebook.stage_table.launches, rulebook.lookup_taps.launches,
              rulebook.downsample.launches)
    for tables in (True, False):
        build = (functools.partial(backbone3d._branch_rulebooks, tables=True) if tables
                 else backbone3d.build_branch_rulebooks)
        books = build(keys, grid, BRANCH_CAPS, **kw)
        names = {n for n in books if not (n.startswith("subm") and n.endswith("_T"))}
        stages = 3 if kw.get("dense_tail") else 4
        strided = stages - 1 if kw.get("dense_tail") or "with_conv_out" in kw else stages
        want = {f"subm{s}" for s in range(1, stages + 1)} | set(
            ("down2", "down3", "down4", "conv_out")[:strided])
        if kw.get("with_transpose"):
            want |= {f"{n}_T" for n in want if not n.startswith("subm")}
        assert names == want, (tables, sorted(names))
        for name in names:
            assert_book(books[name], ref["branch"][name], f"{variant} {name} tables={tables}")
        for s in range(1, stages + 1 if kw.get("with_transpose") else 1):
            flipped = sparse.mirror_rulebook(books[f"subm{s}"])
            assert torch.equal(books[f"subm{s}_T"].idx, flipped.idx)
    occupied = {n: ref["branch"][n]["out_valid"].sum(-1).tolist() for n in ("down2", "down3")}
    assert occupied["down2"][0] == BRANCH_CAPS[0] > occupied["down2"][1] > 0
    assert occupied["down3"][:2] == [BRANCH_CAPS[1]] * 2  # truncated at two stages
    assert counts == (rulebook.stage_table.launches, rulebook.lookup_taps.launches,
                      rulebook.downsample.launches)


def test_wrappers_reject_what_the_kernels_do_not_take():
    grid = sparse.GridSpec(40, 8, 8)
    keys = _t(_keys(grid, (20,), 24))
    table = rulebook.stage_table(keys, grid)
    with pytest.raises(TypeError):
        rulebook.stage_table(keys.long(), grid)
    with pytest.raises(TypeError):
        rulebook.stage_table(keys[0], grid)
    with pytest.raises(ValueError):
        rulebook.stage_table(keys, sparse.GridSpec(2**16, 2**16, 1))
    with pytest.raises(ValueError):  # a submanifold lookup reads its rows' own grid
        rulebook.lookup_taps(keys, sparse.GridSpec(40, 8, 9), table, rulebook.SUBM, (3, 3, 3))
    with pytest.raises(ValueError):
        rulebook.lookup_taps(keys, grid, table, 3, (3, 3, 3))
    with pytest.raises(ValueError):
        rulebook.lookup_taps(keys, grid, table._replace(grid=sparse.GridSpec(40, 9, 8)),
                             rulebook.STRIDED, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    with pytest.raises(ValueError):  # 33 taps along x: beyond B2's 32-bit span
        rulebook.downsample(table, (33, 1, 1), (1, 1, 1), (0, 0, 0), 10)
    with pytest.raises(ValueError):
        rulebook.downsample(table, (3, 3, 3), (0, 1, 1), (0, 0, 0), 10)
    # strides of 5 and 9 along x (an output word's field spans 5 and 9 input
    # words), and kx = 32: the plain version's set
    for geom in (((3, 1, 1), (5, 1, 1), (1, 0, 0)), ((3, 3, 3), (9, 1, 1), (0, 0, 0)),
                 ((32, 1, 1), (1, 1, 1), (0, 0, 0))):
        _, out_keys, _ = rulebook.downsample(table, *geom, 100)
        twin, _ = sparse.build_conv_rulebook_batched(keys, grid, *geom, 100)
        assert torch.equal(out_keys, twin.out_keys), geom


@pytest.mark.slow
def test_rulebook_kernel_reference_regenerated():
    refs.assert_regenerated(REF, jax_reference())
