"""PyTorch port, the host-side launch planner of the two min-sum LDPC
kernels (ops/ldpc/decode.py): the row phases of the layered sweep, the
table blob the kernels read, cluster slices and groups, shared memory per
block and the row-degree classes. All pure functions, checked on the CPU.

And the property the phases rest on: a layered decode that sweeps all
rows of a phase at once (every row reads the LQ the phase started from)
gives the bits, ok flags and full codewords of the row-by-row sweep of
_ldpc_decode_plain, tolerance 0.
"""
import numpy as np
import pytest
import torch

from python_5gtoolbox_tpu_torch.ops.ldpc import ZLIST
from python_5gtoolbox_tpu_torch.ops.ldpc import decode as dec
from python_5gtoolbox_tpu_torch.ops.ldpc.encode import ldpc_encode

SMEM = 232448          # dynamic shared memory a block may opt in to, sm_90
N_SM = 132


@pytest.mark.parametrize("bgn,n_phase", [(1, 32), (2, 28)])
@pytest.mark.parametrize("zc", [2, 12, 80, 144, 288, 384])
def test_phases_cover_rows_in_order_and_share_no_column(bgn, zc, n_phase):
    rows, nrows, _ = dec._graph(bgn, zc)
    ptr = dec.row_phases(bgn, zc)
    assert len(ptr) - 1 == n_phase
    assert ptr[0] == 0 and ptr[-1] == nrows
    assert all(a < b for a, b in zip(ptr, ptr[1:]))
    cols = [{c for c, _ in e} for e in rows]
    for a, b in zip(ptr, ptr[1:]):
        seen = set()
        for r in range(a, b):
            assert not cols[r] & seen, (a, b, r)
            seen |= cols[r]
        # greedy: the next phase starts only where a column repeats
        if b < nrows:
            assert cols[b] & seen
    # the pattern does not depend on the lifting
    assert all(dec.row_phases(bgn, z) == ptr for z in ZLIST)


@pytest.mark.parametrize("bgn,zc", [(1, 384), (2, 80), (1, 2)])
def test_kernel_tables_encode_the_graph(bgn, zc):
    rows, nrows, ncols = dec._graph(bgn, zc)
    ne = sum(len(e) for e in rows)
    tab = dec._kernel_tables(bgn, zc)
    ptr = dec.row_phases(bgn, zc)
    assert tab.dtype == np.int32
    assert len(tab) == nrows + 1 + ne + ncols + 1 + ne + len(ptr) \
        + nrows + ncols
    row_ptr = tab[:nrows + 1]
    row_edge = tab[nrows + 1:nrows + 1 + ne]
    col_ptr = tab[nrows + 1 + ne:nrows + ncols + 2 + ne]
    col_edge = tab[nrows + ncols + 2 + ne:nrows + ncols + 2 + 2 * ne]
    rest = tab[nrows + ncols + 2 + 2 * ne:]
    assert tuple(rest[:len(ptr)]) == ptr
    row_order, col_order = rest[len(ptr):len(ptr) + nrows], rest[-ncols:]
    assert sorted(row_order) == list(range(nrows))
    assert sorted(col_order) == list(range(ncols))
    assert list(np.diff(row_ptr)[row_order]) == \
        sorted(np.diff(row_ptr), reverse=True)
    assert list(np.diff(col_ptr)[col_order]) == \
        sorted(np.diff(col_ptr), reverse=True)
    edges = [(int(w) & 0xffff, int(w) >> 16) for w in row_edge]
    assert [edges[row_ptr[r]:row_ptr[r + 1]] for r in range(nrows)] == \
        [list(e) for e in rows]
    for c in range(ncols):
        ids = col_edge[col_ptr[c]:col_ptr[c + 1]]
        assert all(edges[e][0] == c for e in ids)
        assert list(ids) == sorted(ids)           # rows ascending
    assert sorted(col_edge) == list(range(ne))


def test_row_degree_classes():
    bg1 = dec.row_degree_classes(1, 384)
    assert bg1[:4] == (19,) * 4 and max(bg1[4:]) == 10
    assert max(dec.row_degree_classes(2, 352)) == 10
    for bgn in (1, 2):
        rows, _, _ = dec._graph(bgn, 16)
        for e, w in zip(rows, dec.row_degree_classes(bgn, 16)):
            assert len(e) <= w and w in dec.DEGREE_CLASSES
            assert not any(len(e) <= v < w for v in dec.DEGREE_CLASSES)


@pytest.mark.parametrize("zc", [2, 12, 32, 80, 144, 288, 352, 384])
def test_cluster_slices(zc):
    slices = dec.cluster_slices(zc)
    assert slices[1] == zc
    for k, zl in slices.items():
        if k > 1:
            assert zl >= 8 and zl & (zl - 1) == 0 and zl < zc
            assert -(-zc // zl) == k <= 16


def _layered_by_phase(llr_in, zc, bgn, n_iter, alpha, beta, semantics):
    """_ldpc_decode_plain's layered schedule, each phase's rows swept at
    once from the LQ the phase started from."""
    rows, _, ncols = dec._graph(bgn, zc)
    ptr = dec.row_phases(bgn, zc)
    b = llr_in.shape[0]
    llr0 = torch.cat([llr_in.new_zeros((b, 2 * zc)), llr_in], dim=-1
                     ).reshape(b, ncols, zc)
    alpha, beta = torch.tensor(alpha), torch.tensor(beta)
    node = (dec._check_node_minsum_fast if semantics == "fast"
            else dec._check_node_minsum)
    first = np.cumsum([0] + [len(e) for e in rows])
    lq = llr0
    lr = llr0.new_zeros((b, int(first[-1]), zc))
    done = torch.zeros(b, dtype=torch.bool)
    out_bits = torch.zeros((b, ncols, zc), dtype=torch.bool)
    for _ in range(n_iter):
        bits = lq < 0
        ok = dec._syndrome_ok(bits, rows)
        out_bits = torch.where((ok & ~done)[:, None, None], bits, out_bits)
        done = done | ok
        cur = list(lq.unbind(dim=1))
        new_lr = lr.clone()
        for a, z in zip(ptr, ptr[1:]):
            start = list(cur)
            for r in range(a, z):
                e0, e1 = first[r], first[r + 1]
                ext = torch.stack([dec._fwd(start[c], p) for c, p in rows[r]],
                                  dim=1) - lr[:, e0:e1]
                msg = node(ext, alpha, beta)
                new_lr[:, e0:e1] = msg
                for j, (c, p) in enumerate(rows[r]):
                    cur[c] = dec._bwd((ext + msg)[:, j], p)
        keep = done[:, None, None]
        lq = torch.where(keep, lq, torch.stack(cur, dim=1))
        lr = torch.where(keep, lr, new_lr)
    fbits = lq <= 0
    ok = done | dec._syndrome_ok(fbits, rows)
    full = torch.where(done[:, None, None], out_bits, fbits
                       ).reshape(b, -1).to(torch.int8)
    return full[:, :(22 if bgn == 1 else 10) * zc], ok, full


@pytest.mark.parametrize("semantics", ["exact", "fast"])
@pytest.mark.parametrize("kind", ["noisy", "never converging"])
@pytest.mark.parametrize("bgn,zc", [(1, 10), (2, 16)])
def test_layered_by_phase_equals_row_by_row(bgn, zc, kind, semantics):
    rng = np.random.default_rng(zc)
    ncols = 68 if bgn == 1 else 52
    if kind == "noisy":
        bits = torch.as_tensor(rng.integers(
            0, 2, (8, (22 if bgn == 1 else 10) * zc), dtype=np.int8))
        x = 1 - 2 * ldpc_encode(bits, bgn).to(torch.float32)
        llr = 2.5 * (x + 0.8 * torch.as_tensor(rng.standard_normal(
            tuple(x.shape), dtype=np.float32)))
    else:
        llr = torch.as_tensor(4.0 * rng.standard_normal(
            (8, (ncols - 2) * zc), dtype=np.float32))
        llr[:, ::7] = 0.0
    got = _layered_by_phase(llr, zc, bgn, 6, 0.8, 0.3, semantics)
    ref = dec._ldpc_decode_plain(llr, zc, bgn, 6, 0.8, 0.3, "layered",
                                 semantics)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if kind == "noisy":
        assert ref[1].any()
    else:
        assert not ref[1].any()


@pytest.mark.parametrize("bgn,zc,batch,layout", [
    (2, 352, 20, "batch"), (1, 384, 20, "batch"), (2, 352, 512, "batch"),
    (2, 288, 20, "batch"),
    (1, 384, 512, "batch"), (1, 12, 400, "packed"), (2, 80, 20, "packed"),
    (2, 112, 400, "packed")])
@pytest.mark.parametrize("schedule", ["flooded", "layered"])
def test_plan_fits_and_fills_the_sms(bgn, zc, batch, layout, schedule):
    """The shared memory fits; flooded, the largest cluster whose blocks
    still fit one per SM (the smallest that fits where none does);
    layered, the smallest cluster that fits, or LQ in one block and LR in
    device memory where the clusters would not fit in one wave."""
    plan = dec.plan_launch(bgn, zc, batch, schedule, layout, N_SM)
    assert plan.smem == dec.smem_bytes(bgn, zc, plan.group, plan.zl,
                                       plan.lr_on_chip) <= SMEM
    n_clusters = -(-batch // plan.group)
    assert plan.blocks == n_clusters * plan.cluster
    assert dec.cluster_slices(zc)[plan.cluster] == plan.zl
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    fits = [k for k, zl in dec.cluster_slices(zc).items()
            if dec.smem_bytes(bgn, zc, plan.group, zl) <= SMEM]
    one_wave = [k for k in fits if n_clusters * k <= N_SM]
    assert plan.lr_on_chip == (schedule == "flooded" or 1 in fits
                               or bool(one_wave))
    if not plan.lr_on_chip:
        assert (plan.cluster, plan.zl, plan.threads) == (1, zc, 512)
    elif schedule == "flooded" and one_wave:
        assert plan.cluster == max(one_wave)
        assert plan.blocks > N_SM // 2 or plan.cluster == max(fits)
    else:
        assert plan.cluster == fits[0]
    if layout == "packed" and not plan.warp:
        assert plan.group == min(dec.packed_group_limit(zc, bgn),
                                 -(-batch // N_SM))


def test_plan_shapes_of_the_main_paths():
    # the bench sweep: 20 codewords of Zc 352 over clusters of 6 blocks
    p = dec.plan_launch(2, 352, 20, "flooded", "batch", N_SM)
    assert (p.cluster, p.zl, p.blocks, p.barriers) == (6, 64, 120, 3)
    # the decoder bench: flooded, three blocks of 128 lifting indices per
    # codeword; layered, LQ in one block and LR in device memory
    p = dec.plan_launch(1, 384, 512, "flooded", "batch", N_SM)
    assert (p.cluster, p.zl, p.barriers, p.lr_on_chip) == (3, 128, 3, True)
    p = dec.plan_launch(1, 384, 512, "layered", "batch", N_SM)
    assert (p.cluster, p.zl, p.barriers, p.lr_on_chip) == \
        (1, 384, 2 + 32, False)
    # ... and at the sweep's batch the layered state stays on chip
    p = dec.plan_launch(1, 384, 20, "layered", "batch", N_SM)
    assert (p.cluster, p.zl, p.lr_on_chip) == (3, 128, True)
    # the decoder study: four codewords per block, two side by side in a
    # warp; layered, a warp per two codewords and no block barrier
    p = dec.plan_launch(1, 12, 400, "flooded", "packed", N_SM)
    assert (p.cluster, p.group, p.blocks, p.warp, p.barriers) == \
        (1, 4, 100, False, 3)
    p = dec.plan_launch(1, 12, 400, "layered", "packed", N_SM)
    assert (p.cluster, p.group, p.threads, p.warp, p.barriers) == \
        (1, 2, 32, True, 0)
    # the small-allocation sweep: one codeword over five blocks
    p = dec.plan_launch(2, 80, 20, "flooded", "packed", N_SM)
    assert (p.cluster, p.group, p.zl, p.blocks) == (5, 1, 16, 100)
    # the UL sweep (TBS 2600, BG2, Zc 288): slices of 64 lifting indices,
    # the last one 32 wide
    p = dec.plan_launch(2, 288, 20, "flooded", "batch", N_SM)
    assert (p.cluster, p.zl, p.blocks, p.barriers) == (5, 64, 100, 3)
    assert dec.cluster_slices(288) == {1: 288, 2: 256, 3: 128, 5: 64,
                                       9: 32}


@pytest.mark.parametrize("kw", [
    dict(cluster=2), dict(cluster=5), dict(cluster=17), dict(threads=48),
    dict(threads=2048), dict(group=2), dict(layout="packed", group=13),
    dict(layout="packed", schedule="layered", cluster=2),
    dict(cluster=3, lr_on_chip=False),
    dict(layout="packed", lr_on_chip=False)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_plan_rejects_what_does_not_fit(kw):
    kw = dict(kw)
    layout = kw.pop("layout", "batch")
    zc = 12 if layout == "packed" else 384
    with pytest.raises(ValueError):
        dec.plan_launch(1, zc, 20, kw.pop("schedule", "flooded"), layout,
                        N_SM, **kw)


@pytest.mark.parametrize("name,kw", [
    ("ldpc_minsum", dict(cluster=2)), ("ldpc_minsum", dict(threads=256)),
    ("ldpc_minsum_packed", dict(group=2, cluster=1))])
def test_wrappers_raise_on_cpu_tensors(name, kw):
    layout = "packed" if name == "ldpc_minsum_packed" else "batch"
    plan = dec.plan_launch(2, 16, 2, "flooded", layout, N_SM, **kw)
    for p in (None, plan):
        with pytest.raises(ValueError, match="CUDA tensor"):
            getattr(dec, name)(torch.zeros((2, 50 * 16)), 16, 2, 4, plan=p)


@pytest.mark.parametrize("layout,kw", [
    ("batch", dict(cluster=6)), ("batch", dict(cluster=1, lr_on_chip=False)),
    ("batch", dict(threads=256)), ("packed", dict(group=2)),
    ("packed", dict(cluster=5))])
def test_checked_plan_takes_a_forced_plan_for_its_own_decode(layout, kw):
    """A plan forced through plan_launch goes through unchanged; handed
    to a decode of another code, batch or schedule, for which plan_launch
    would not give it, it raises."""
    zc = 352 if layout == "batch" else 80
    plan = dec.plan_launch(2, zc, 20, "flooded", layout, N_SM, **kw)
    assert dec.checked_plan(plan, 2, zc, 20, "flooded", layout, N_SM) is plan
    assert dec.checked_plan(None, 2, zc, 20, "flooded", layout, N_SM) == \
        dec.plan_launch(2, zc, 20, "flooded", layout, N_SM)
    for args in [(2, zc, 21, "flooded", layout),
                 (2, zc, 20, "layered", layout),
                 (2, 80 if layout == "batch" else 96, 20, "flooded", layout),
                 (1, zc, 20, "flooded", layout)]:
        with pytest.raises(ValueError):
            dec.checked_plan(plan, *args, N_SM)


def test_profile_sweep_names_every_kernel():
    """profile_sweep picks the port's kernels from the profiler's rows by
    their __global__ names: every kernel in csrc/ has its entry, and every
    entry names a kernel."""
    import pathlib
    import re
    from python_5gtoolbox_tpu_torch.sim import profile_sweep
    csrc = pathlib.Path(dec.__file__).parents[2] / "csrc"
    names = set()
    for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    assert {k.split("::")[-1] for k in profile_sweep.PORT_KERNELS} == names


@pytest.mark.parametrize("algo", ["min-sum", "BP"])
def test_ldpc_decode_plain_path_refuses_iters_out(algo):
    """ldpc_decode hands iters_out to the card's kernels only: the plain
    decoder (a CPU tensor, or BP anywhere) counts no iterations and
    refuses it; without it the same call decodes."""
    zc = 16
    llr = torch.full((2, 50 * zc), 4.0)
    iters = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="iters_out"):
        dec.ldpc_decode(llr, zc, 2, 4, algo=algo, iters_out=iters)
    bits, ok, _ = dec.ldpc_decode(llr, zc, 2, 4, algo=algo)
    assert bool(ok.all()) and not bits.any()
