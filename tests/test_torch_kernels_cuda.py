"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX, so it also runs where only the port is installed):

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from rt3d_torch import kernels
from rt3d_torch.geometry import ops, sor, subtract

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(7)


def _keys(gen, h, w, sent=0.3):
    kg = torch.randint(0, 50, (h, w), device="cuda", generator=gen, dtype=torch.int32)
    mask = torch.rand((h, w), device="cuda", generator=gen) < sent
    return torch.where(mask, ops.INT_SENTINEL, kg).to(torch.int32)


@pytest.mark.parametrize("h,w,dy,dx", [(360, 640, 4, 6), (37, 53, 4, 6), (24, 128, 2, 3),
                                       (9, 40, 0, 1)])
def test_window_kernels_equal_plain(gen, h, w, dy, dx):
    kg = _keys(gen, h, w)
    wg = torch.randint(0, 2**20, (h, w), device="cuda", generator=gen, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(ops.window_dedupe(kg, dy, dx), ops.window_dedupe(kg, dy, dx, plain=True))
    assert torch.equal(ops.window_prev_or(kg, wg, dy, dx),
                       ops.window_prev_or(kg, wg, dy, dx, plain=True))
    assert kernels.LAUNCHES["window_dedupe"] == before["window_dedupe"] + 1
    assert kernels.LAUNCHES["window_prev_or"] == before["window_prev_or"] + 1


@pytest.mark.parametrize("s,cap,k", [(20, 2048, 20), (3, 512, 20), (2, 300, 7), (1, 5000, 32)])
def test_sor_knn_equals_plain(gen, s, cap, k):
    pts = (torch.randint(-30, 30, (s, cap, 3), device="cuda", generator=gen).float() * 0.005
           + torch.randn((s, cap, 3), device="cuda", generator=gen) * 1e-3).contiguous()
    n = torch.randint(0, cap + 1, (s, 1), device="cuda", generator=gen)
    valid = torch.arange(cap, device="cuda")[None] < n
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)


@pytest.mark.parametrize("n,m,nvalid", [(131072, 20480, 3000), (1000, 1500, 0), (77, 3, 3)])
def test_min_sqdist_equals_plain(gen, n, m, nvalid):
    q = (torch.randint(-100, 100, (n, 3), device="cuda", generator=gen).float() * 0.005).contiguous()
    r = (torch.randint(-40, 40, (m, 3), device="cuda", generator=gen).float() * 0.005).contiguous()
    rv = torch.arange(m, device="cuda") < nvalid
    assert torch.equal(subtract.min_sqdist(q, r, rv), subtract.min_sqdist(q, r, rv, plain=True))


def test_wrappers_reject_bad_tensors(gen):
    kg = _keys(gen, 16, 16)
    with pytest.raises(TypeError):
        ops.window_dedupe(kg.long())
    with pytest.raises(ValueError):
        ops.window_dedupe(kg.t())
    with pytest.raises(ValueError):
        sor.sor_knn_mean_slots(torch.zeros(1, 8, 3, device="cuda"),
                               torch.ones(1, 8, dtype=torch.bool, device="cuda"), 40)


def _cloud(gen, n, invalid=0.3):
    pts = (torch.randint(-30, 30, (n, 3), device="cuda", generator=gen).float() * 0.005
           + torch.randn((n, 3), device="cuda", generator=gen) * 1e-3).contiguous()
    return pts, torch.rand(n, device="cuda", generator=gen) >= invalid


@pytest.mark.parametrize("n", [256, 3000, 4096])
def test_sor_knn_cloud_equals_plain(gen, n):
    """K5 equals its plain version bit for bit, one launch a call."""
    pts, valid = _cloud(gen, n)
    before = kernels.LAUNCHES["sor_knn"]
    mean, sat = sor.sor_knn_mean(pts, valid, 20)
    assert kernels.LAUNCHES["sor_knn"] == before + 1
    pmean, psat = sor.sor_knn_mean(pts, valid, 20, plain=True)
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)


def test_sor_knn_cloud_equals_slot_rows(gen):
    """K5 over each slot's cloud gives K3's row for that slot bit for bit."""
    s, cap = 6, 2048
    pts = (torch.randint(-30, 30, (s, cap, 3), device="cuda", generator=gen).float() * 0.005
           + torch.randn((s, cap, 3), device="cuda", generator=gen) * 1e-3).contiguous()
    n = torch.tensor([2048, 1500, 300, 19, 1, 0], device="cuda")[:, None]
    valid = torch.arange(cap, device="cuda")[None] < n
    mean, sat = sor.sor_knn_mean_slots(pts, valid, 20)
    for i in range(s):
        m, st = sor.sor_knn_mean(pts[i], valid[i], 20)
        assert torch.equal(m, mean[i]) and torch.equal(st, sat[i])


def test_sor_entry_points_launch_k5(gen):
    """`sor_inlier_mask` from 256 to 4096 rows launches K5 once and equals
    its plain run; below 256 rows it launches nothing."""
    pts, valid = _cloud(gen, 2048)
    before = kernels.LAUNCHES["sor_knn"]
    keep = sor.sor_inlier_mask(pts, valid)
    assert kernels.LAUNCHES["sor_knn"] == before + 1
    assert torch.equal(keep, sor.sor_inlier_mask(pts, valid, plain=True))
    assert torch.equal(sor.sor_filter(ops.PointBuffer(pts, valid)).valid, keep)
    small, sv = _cloud(gen, 200)
    sor.sor_inlier_mask(small, sv)
    assert kernels.LAUNCHES["sor_knn"] == before + 2


def test_mask_ops_and_windowed_sor_match_cpu(gen):
    """Erosion and dilation on the card equal the CPU's bit for bit; the
    Morton-window SOR's keys equal and its keep mask equals the CPU's
    outside a band of 1e-5 of the threshold (sums in another order)."""
    from rt3d_torch.geometry import image

    m = torch.rand((2, 4, 72, 128), device="cuda", generator=gen) < 0.8
    for k in (3, 12):
        assert torch.equal(image.erode_mask(m, k).cpu(), image.erode_mask(m.cpu(), k))
        assert torch.equal(image.dilate_mask(m, k).cpu(), image.dilate_mask(m.cpu(), k))
    pts, valid = _cloud(gen, 20000, invalid=0.2)
    assert torch.equal(sor.morton_keys(pts, valid).cpu(), sor.morton_keys(pts.cpu(), valid.cpu()))
    keep = sor.sor_inlier_mask_windowed(pts, valid).cpu()
    ckeep = sor.sor_inlier_mask_windowed(pts.cpu(), valid.cpu())
    mean, sat = sor._knn_mean_windowed(pts.cpu(), valid.cpu(), 20, 64)
    ok = valid.cpu() & ~sat
    thr = mean[ok].double().mean() + 1.5 * mean[ok].double().std()
    outside = (mean.double() - thr).abs() > 1e-5 * thr
    assert torch.equal(keep[outside], ckeep[outside])
    assert 0 < keep.sum() < valid.sum()


def _slots(gen, cap, n_valids, layout):
    """Slots of `cap` lattice points, slot i with n_valids[i] valid rows:
    scattered at random, or in the fusion's two-run layout (the front of
    each half, as camera 1's rows then its partner's); "dups" repeats
    every third point in the next row, so distances tie."""
    s = len(n_valids)
    pts = (torch.randint(-30, 30, (s, cap, 3), device="cuda", generator=gen).float() * 0.005
           + torch.randn((s, cap, 3), device="cuda", generator=gen) * 1e-3)
    if layout == "dups":
        pts[:, 1::3] = pts[:, 0::3][:, :pts[:, 1::3].shape[1]]
    n = torch.tensor(n_valids, device="cuda")[:, None]
    if layout == "two_runs":
        half = cap // 2
        col = torch.arange(cap, device="cuda")[None]
        first = torch.clamp_max(n, half)
        valid = (col < first) | ((col >= half) & (col < half + n - first))
    else:
        rank = torch.rand((s, cap), device="cuda", generator=gen).argsort(-1).argsort(-1)
        valid = rank < n
    return pts.contiguous(), valid


@pytest.mark.parametrize("layout", ["scattered", "two_runs", "dups"])
@pytest.mark.parametrize("k", [1, 2, 20, 24, 32])
@pytest.mark.parametrize("cap", [256, 300, 2048, 4096])
def test_sor_knn_equals_plain_bitwise(gen, cap, k, layout):
    """K3 over slots with 0, 1, k - 1, k, k + 1 and cap valid rows, and K5
    over each slot's cloud, equal the plain version bit for bit on every
    row (invalid rows included: 3.4e38, saturated). 300 rows match no
    block or group multiple."""
    n_valids = sorted({0, 1, max(k - 1, 0), k, k + 1, cap})
    pts, valid = _slots(gen, cap, n_valids, layout)
    before = dict(kernels.LAUNCHES)
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    assert kernels.LAUNCHES["sor_knn_slots"] == before["sor_knn_slots"] + 1
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)
    for i in range(len(n_valids)):
        m, st = sor.sor_knn_mean(pts[i], valid[i], k)
        assert torch.equal(m, mean[i]) and torch.equal(st, sat[i])


def test_sor_inlier_mask_slots_below_kernel_size(gen):
    """Slots of 128 rows take the exact form on the card too: k = 40, above
    the kernels' 32, runs, launches no K3, and equals `sor_inlier_mask` on
    each slot's cloud."""
    pts, valid = _slots(gen, 128, [128, 90, 15, 0], "scattered")
    before = dict(kernels.LAUNCHES)
    keep = sor.sor_inlier_mask_slots(pts, valid, 40, 1.5)
    assert kernels.LAUNCHES == before
    for i in range(4):
        assert torch.equal(keep[i], sor.sor_inlier_mask(pts[i], valid[i], 40, 1.5))
    assert 0 < int(keep[0].sum()) < 128 and not keep[2:].any()


def test_sor_knn_rejects_bad_tensors(gen):
    """k outside [1, rows] and bad tensors raise before any launch."""
    pts, valid = _cloud(gen, 300)
    before = dict(kernels.LAUNCHES)
    for k in (0, 301):
        with pytest.raises(ValueError):
            sor.sor_knn_mean(pts, valid, k)
        with pytest.raises(ValueError):
            sor.sor_knn_mean_slots(pts[None], valid[None], k)
    with pytest.raises(TypeError):
        sor.sor_knn_mean(pts.double(), valid, 20)
    with pytest.raises(ValueError):
        sor.sor_knn_mean(pts.t().contiguous().t(), valid, 20)
    with pytest.raises(ValueError):
        sor.sor_knn_mean(pts, valid[:-1], 20)
    assert kernels.LAUNCHES == before


def _no_plain(monkeypatch):
    """Make the plain SOR statistic, `torch.topk` and `torch.cdist` raise:
    a kernel call must run none of them."""
    def refuse(*a, **kw):
        raise AssertionError("a plain path ran")

    for mod, name in ((sor, "sor_knn_mean_plain"), (torch, "topk"), (torch, "cdist"),
                      (ops, "window_dedupe_plain"), (ops, "window_prev_or_plain")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("k", [33, 40, 64, 100, 300])
def test_sor_knn_large_k_equals_plain(gen, monkeypatch, k):
    """K5 at k above the register path's 32, up to the cloud's 300 rows:
    bit for bit its plain version, one launch of the radix-select kernel,
    no plain path run."""
    pts, valid = _cloud(gen, 300)
    pmean, psat = sor.sor_knn_mean(pts, valid, k, plain=True)
    before = dict(kernels.LAUNCHES)
    with monkeypatch.context() as m:
        _no_plain(m)
        mean, sat = sor.sor_knn_mean(pts, valid, k)
    assert kernels.LAUNCHES["sor_knn"] == before["sor_knn"] + 1
    assert kernels.LAUNCHES["sor_knn_large_k"] == before["sor_knn_large_k"] + 1
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)


@pytest.mark.parametrize("layout", ["scattered", "two_runs", "dups"])
@pytest.mark.parametrize("k", [33, 48, 64, 256, "cap"])
@pytest.mark.parametrize("cap", [256, 300, 2048, 4096])
def test_sor_knn_large_k_equals_plain_bitwise(gen, cap, k, layout):
    """K3 at k above 32, up to k = cap, over slots with 0, 1, k - 1, k,
    k + 1 and cap valid rows, and K5 over each slot's cloud: bit for bit
    the plain version on every row (invalid rows included), K3's launch
    counted as a large-k one."""
    k = cap if k == "cap" else k
    n_valids = sorted({n for n in (0, 1, k - 1, k, k + 1, cap) if n <= cap})
    pts, valid = _slots(gen, cap, n_valids, layout)
    before = dict(kernels.LAUNCHES)
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    assert kernels.LAUNCHES["sor_knn_slots"] == before["sor_knn_slots"] + 1
    assert kernels.LAUNCHES["sor_knn_slots_large_k"] == before["sor_knn_slots_large_k"] + 1
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)
    for i in range(len(n_valids)):
        m, st = sor.sor_knn_mean(pts[i], valid[i], k)
        assert torch.equal(m, mean[i]) and torch.equal(st, sat[i])


def test_sor_knn_refused_launch_raises(gen):
    """A slot of 16 384 rows asks either path (k = 40 and k = 20) for more
    shared memory than a block may have: the refused launch raises and
    counts nothing, and leaves no error behind for the next launch, ours
    or PyTorch's."""
    pts, valid = _slots(gen, 16384, [9000], "scattered")
    before = dict(kernels.LAUNCHES)
    for k in (40, 20):
        with pytest.raises(RuntimeError):
            sor.sor_knn_mean_slots(pts, valid, k)
    assert kernels.LAUNCHES == before
    small, sv = _slots(gen, 300, [200], "scattered")
    mean, sat = sor.sor_knn_mean_slots(small, sv, 40)
    assert torch.equal(mean, sor.sor_knn_mean_slots(small, sv, 40, plain=True)[0])
    torch.cuda.synchronize()


def test_sor_inlier_mask_slots_at_50_neighbours(gen, monkeypatch):
    """The fused step's call, `sor_inlier_mask_slots` at nb_neighbors = 50
    on 20 slots of 2048: one K3 launch through the radix-select kernel, no
    plain path, and its plain run's keep masks."""
    pts, valid = _slots(gen, 2048, [1500, 900, 700, 400, 300, 120, 49, 15] + [0] * 12,
                        "two_runs")
    exp = sor.sor_inlier_mask_slots(pts, valid, 50, 1.5, plain=True)
    before = dict(kernels.LAUNCHES)
    with monkeypatch.context() as m:
        _no_plain(m)
        keep = sor.sor_inlier_mask_slots(pts, valid, 50, 1.5)
    assert kernels.LAUNCHES["sor_knn_slots_large_k"] == before["sor_knn_slots_large_k"] + 1
    assert torch.equal(keep, exp) and 0 < int(keep.sum()) < int(valid.sum())


# ---------------------------------------------------------------------------
# K4 under a threshold, K2 on mostly-sentinel grids
# ---------------------------------------------------------------------------


def _assert_k4_contract(d2, pd2, qv, thr):
    """The threshold contract of `subtract.min_sqdist`: bit for bit where the
    plain d2 <= t2 (t2 = f32(thr) * f32(thr)), > t2 on the other valid
    queries, 3.4e38 on invalid queries in both."""
    t = torch.tensor(thr, dtype=torch.float32, device="cuda")
    t2 = t * t
    big = torch.tensor(subtract.BIG, dtype=torch.float32, device="cuda")
    near = qv & (pd2 <= t2)
    assert torch.equal(d2[near], pd2[near])
    assert bool((d2[qv & ~near] > t2).all())
    assert bool((d2[~qv] == big).all()) and bool((pd2[~qv] == big).all())
    return near


def _workspace(gen, n, n_valid, holes=0.1):
    """Workspace-shaped queries: `n_valid` rows of a 5 mm lattice over a
    1 m x 2.25 m x 0.2 m box, sorted x-major by voxel key, some of them
    holes at (0, 0, 0) and invalid, then an invalid (0, 0, 0) tail."""
    lat = torch.stack([torch.randint(-50, 150, (n_valid,), device="cuda", generator=gen),
                       torch.randint(-100, 350, (n_valid,), device="cuda", generator=gen),
                       torch.randint(-10, 30, (n_valid,), device="cuda", generator=gen)], 1)
    key = ((lat[:, 0] + 512) * 1024 + lat[:, 1] + 512) * 1024 + lat[:, 2] + 512
    pts = torch.zeros((n, 3), device="cuda")
    pts[:n_valid] = lat[key.argsort()].float() * 0.005
    valid = torch.arange(n, device="cuda") < n_valid
    valid &= torch.rand(n, device="cuda", generator=gen) >= holes
    return torch.where(valid[:, None], pts, 0.0).contiguous(), valid


def _objects(gen, m, n_valid):
    """Object-shaped references: `n_valid` compacted valid rows from two
    lattice blobs, each sorted by key, zeros after them."""
    half = n_valid // 2
    r = torch.zeros((m, 3), device="cuda")
    for i, (lo, n) in enumerate((((30, 80, 0), half), ((40, 180, 0), n_valid - half))):
        lat = (torch.randint(0, 24, (n, 3), device="cuda", generator=gen)
               + torch.tensor(lo, device="cuda"))
        key = (lat[:, 0] * 1024 + lat[:, 1]) * 1024 + lat[:, 2]
        r[i * half:i * half + n] = lat[key.argsort()].float() * 0.005
    return r.contiguous(), torch.arange(m, device="cuda") < n_valid


@pytest.mark.parametrize("n,n_valid,m,m_valid", [(131072, 90000, 20480, 2000),
                                                 (1048576, 700000, 32768, 20000),
                                                 (1000, 700, 333, 130), (300, 257, 300, 290)])
def test_min_sqdist_threshold_contract(gen, n, n_valid, m, m_valid):
    """K4 with the step's threshold and query validity on sorted lattice
    queries with holes and an invalid tail, against compacted object
    references (the 2cam step's shapes, the stretch step's 1 048 576
    queries against 32 768 references, and small ragged ones): the threshold
    contract, one launch a call, and every valid query exact without a
    threshold."""
    q, qv = _workspace(gen, n, n_valid)
    r, rv = _objects(gen, m, m_valid)
    before = kernels.LAUNCHES["min_sqdist"]
    d2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv)
    assert kernels.LAUNCHES["min_sqdist"] == before + 1
    pd2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv, plain=True)
    near = _assert_k4_contract(d2, pd2, qv, 0.06)
    assert int(near.sum()) > 0
    exact = subtract.min_sqdist(q, r, rv, query_valid=qv)
    assert torch.equal(exact, pd2)
    assert torch.equal(subtract.min_sqdist(q, r, rv), subtract.min_sqdist(q, r, rv, plain=True))


def test_min_sqdist_refs_on_threshold_sphere(gen):
    """References at exactly the threshold from lattice queries, along an
    axis and on (8, 8, 4) diagonals of the 5 mm lattice, so computed d2 fall
    on both sides of t2 and on it: the box tests drop none of them wrongly."""
    q, qv = _workspace(gen, 4096, 4096, holes=0.0)
    steps = torch.tensor([[12, 0, 0], [0, -12, 0], [0, 0, 12], [7, 0, 0],
                          [8, 8, 4], [-4, 8, -8]], device="cuda")
    pick = torch.randint(0, 4096, (600,), device="cuda", generator=gen)
    step = steps[torch.randint(0, len(steps), (600,), device="cuda", generator=gen)]
    r = (q[pick] + step.float() * 0.005).contiguous()
    rv = torch.ones(600, dtype=torch.bool, device="cuda")
    d2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv)
    pd2 = subtract.min_sqdist(q, r, rv, threshold=0.06, query_valid=qv, plain=True)
    _assert_k4_contract(d2, pd2, qv, 0.06)
    t = torch.tensor(0.06, dtype=torch.float32, device="cuda")
    assert int(((pd2 - t * t).abs() <= 1e-9).sum()) > 0


def test_min_sqdist_no_valid_reference(gen):
    q, qv = _workspace(gen, 5000, 4000)
    r, _ = _objects(gen, 1000, 800)
    rv = torch.zeros(1000, dtype=torch.bool, device="cuda")
    big = torch.full((5000,), subtract.BIG, dtype=torch.float32, device="cuda")
    for kw in ({"threshold": 0.06, "query_valid": qv}, {}):
        assert torch.equal(subtract.min_sqdist(q, r, rv, **kw), big)
        assert torch.equal(subtract.min_sqdist(q, r, rv, plain=True, **kw), big)


def _sparse_grid(gen, h, w, sent_words):
    """A grid that is sentinel with word 0 but for a few live rectangles, as
    the object-mask path gives it; with `sent_words`, some sentinel pixels
    away from them carry non-zero words, which the block skip must see."""
    kg = torch.full((h, w), ops.INT_SENTINEL, dtype=torch.int32, device="cuda")
    wg = torch.zeros((h, w), dtype=torch.int32, device="cuda")
    for _ in range(3):
        r0 = int(torch.randint(0, max(h - 8, 1), (1,), device="cuda", generator=gen))
        c0 = int(torch.randint(0, max(w - 12, 1), (1,), device="cuda", generator=gen))
        rh, cw = min(8 + r0 % 30, h - r0), min(12 + c0 % 90, w - c0)
        kg[r0:r0 + rh, c0:c0 + cw] = torch.randint(0, 6, (rh, cw), device="cuda", generator=gen,
                                                     dtype=torch.int32)
        wg[r0:r0 + rh, c0:c0 + cw] = torch.randint(1, 2**10, (rh, cw), device="cuda",
                                                     generator=gen, dtype=torch.int32)
    if sent_words:
        spots = (torch.rand((h, w), device="cuda", generator=gen) < 0.002) & (kg == ops.INT_SENTINEL)
        wg = torch.where(spots, 5, wg).to(torch.int32)
    return kg, wg


@pytest.mark.parametrize("sent_words", [False, True])
@pytest.mark.parametrize("h,w", [(720, 1280), (37, 53), (45, 131), (16, 128), (3, 5)])
def test_window_prev_or_sparse_grids(gen, h, w, sent_words):
    """K2 on mostly-sentinel grids, with and without words under sentinel
    keys, at widths that are and are not multiples of 4 and of the tile:
    equal to the plain version, one launch a call."""
    kg, wg = _sparse_grid(gen, h, w, sent_words)
    before = kernels.LAUNCHES["window_prev_or"]
    got = ops.window_prev_or(kg, wg)
    assert kernels.LAUNCHES["window_prev_or"] == before + 1
    assert torch.equal(got, ops.window_prev_or(kg, wg, plain=True))


@pytest.mark.parametrize("window", [(-1, 6), (4, -1), (-3, -2)])
@pytest.mark.parametrize("kernel", ["window_dedupe", "window_prev_or"])
def test_window_kernels_reject_negative_window(gen, kernel, window):
    """K1 and K2 raise for a negative extent, before any launch."""
    kg = _keys(gen, 16, 16)
    args = (kg,) if kernel == "window_dedupe" else (kg, kg)
    before = kernels.LAUNCHES[kernel]
    with pytest.raises(ValueError):
        getattr(ops, kernel)(*args, *window)
    assert kernels.LAUNCHES[kernel] == before


@pytest.mark.parametrize("window", [(5, 6), (4, 7), (8, 12), (16, 3), (0, 9), (7, 0),
                                    (40, 700)])
@pytest.mark.parametrize("h,w", [(720, 1280), (37, 53), (3, 5)])
def test_window_kernels_take_wide_windows(gen, monkeypatch, h, w, window):
    """K1 and K2 beyond 4 x 6 (the wide kernel; windows past the grid's
    edge included), on dense keys, on grids shaped like the step's and on
    sparse ones with words under sentinel keys: bit for bit their plain
    versions, one launch each, no plain path run."""
    grids = [(_keys(gen, h, w),
              torch.randint(0, 2**20, (h, w), device="cuda", generator=gen, dtype=torch.int32)),
             (_step_like_grid(gen, h, w, "banded"), None), _sparse_grid(gen, h, w, True)]
    for kg, wg in grids:
        wg = torch.where(kg == ops.INT_SENTINEL, 0, kg).to(torch.int32) if wg is None else wg
        exp1 = ops.window_dedupe(kg, *window, plain=True)
        exp2 = ops.window_prev_or(kg, wg, *window, plain=True)
        before = dict(kernels.LAUNCHES)
        with monkeypatch.context() as m:
            _no_plain(m)
            got1 = ops.window_dedupe(kg, *window)
            got2 = ops.window_prev_or(kg, wg, *window)
        assert kernels.LAUNCHES["window_dedupe"] == before["window_dedupe"] + 1
        assert kernels.LAUNCHES["window_prev_or"] == before["window_prev_or"] + 1
        assert torch.equal(got1, exp1)
        assert torch.equal(got2, exp2)


def _step_like_grid(gen, h, w, kind):
    """Keys with the step's locality (runs of equal keys over 2 x 3 pixels):
    "banded" makes 45 % of them sentinel in whole row bands and a column
    band, so all-sentinel tiles lie next to dense ones, as the workspace
    grids have them; "all_sentinel" and "no_sentinel" as named."""
    r = torch.arange(h, device="cuda")[:, None]
    c = torch.arange(w, device="cuda")[None, :]
    kg = (r // 2 * 4096 + c // 3).to(torch.int32)
    kg = kg + torch.randint(0, 2, (h, w), device="cuda", generator=gen, dtype=torch.int32)
    if kind == "no_sentinel":
        return kg
    if kind == "all_sentinel":
        return torch.full_like(kg, ops.INT_SENTINEL)
    sent = ((r // 8) % 20 < 6) | ((c >= 128) & (c < 256) & (r // 8 % 2 == 1))
    sent = sent | (torch.rand((h, w), device="cuda", generator=gen) < 0.02)
    return torch.where(sent, ops.INT_SENTINEL, kg).to(torch.int32)


@pytest.mark.parametrize("kind", ["banded", "all_sentinel", "no_sentinel"])
@pytest.mark.parametrize("h,w", [(360, 640), (37, 53), (45, 131), (3, 5), (16, 128)])
def test_window_dedupe_equals_plain(gen, h, w, kind):
    """K1 on grids shaped like the step's, with whole sentinel bands, and on
    all-sentinel and sentinel-free grids, at widths that are and are not
    multiples of 4 and of the tile, for every window up to 4 x 6: bit for
    bit its plain version, one launch a call."""
    kg = _step_like_grid(gen, h, w, kind)
    for dy in range(5):
        for dx in (0, 1, 6):
            before = kernels.LAUNCHES["window_dedupe"]
            got = ops.window_dedupe(kg, dy, dx)
            assert kernels.LAUNCHES["window_dedupe"] == before + 1
            assert torch.equal(got, ops.window_dedupe(kg, dy, dx, plain=True)), (dy, dx)


# ---------------------------------------------------------------------------
# The replay driver on the card
# ---------------------------------------------------------------------------


class _BadFrame:
    """A synthetic source whose camera 1 fails (status 7) at frame `bad`."""

    def __init__(self, src, bad):
        self.src, self.bad = src, bad

    def get(self, i):
        pkt = self.src.get(i)
        if i == self.bad:
            pkt.status = pkt.status.copy()
            pkt.status[1] = 7
        return pkt


def _small_pipeline():
    """The committed n weights on two synthetic cameras at 240x320, model
    input (192, 256), 1 cm voxels and small capacities, bf16 as on the card."""
    import os

    from rt3d_torch.config import Config, ModelConfig, PipelineConfig, TrackerConfig, with_cameras
    from rt3d_torch.io import SyntheticSource
    from rt3d_torch.pipeline.step import build_pipeline

    src = SyntheticSource(num_cameras=2, num_frames=6, hw=(240, 320), num_objects=2)
    cfg = with_cameras(Config(
        model=ModelConfig(variant="n", input_hw=(192, 256), max_detections=4,
                          nms_pre_topk=16, conf_thresh=0.05, class_filter=()),
        tracker=TrackerConfig(max_tracks=16),
        pipeline=PipelineConfig(voxel_size=0.01, max_points_per_object=256,
                                max_points_fused_object=512, max_points_workspace=4096,
                                max_points_workspace_fused=8192, max_objects_fused=8)),
        src.cameras())
    weights = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "weights", "yolo11n_synth_seg.npz")
    return build_pipeline(cfg, weights=weights), src


def test_driver_upload_is_waited_for(gen):
    """The uploader's pinned, side-stream copies land before the compute
    stream reads them: its event is recorded, the compute stream waits on
    it, and what arrives equals the host arrays."""
    import numpy as np

    from rt3d_torch.runtime import PipelineDriver

    pipe, _ = _small_pipeline()
    drv = PipelineDriver(pipe)
    rng = np.random.default_rng(0)
    host = (rng.integers(0, 255, (2, 720, 1280, 3), dtype=np.uint8),
            rng.uniform(0.3, 3.0, (2, 720, 1280)).astype(np.float32))
    side = torch.cuda.Stream()
    (rgb, depth), ready = drv._upload(host, side)
    assert isinstance(ready, torch.cuda.Event) and rgb.is_cuda and depth.is_cuda
    drv._adopt((rgb, depth), ready)
    total = rgb.to(torch.int64).sum() + depth.double().sum()  # on the compute stream
    want = int(host[0].astype(np.int64).sum()) + float(host[1].astype(np.float64).sum())
    assert abs(float(total) - want) < 1e-6 * abs(want)
    assert torch.equal(rgb.cpu(), torch.from_numpy(host[0]))


def test_driver_depths_and_scan_agree_on_card(gen):
    """Depth 1, depth 2 and two frames a call give the same outputs bit for
    bit on the card, skip the bad frame, and launch K1, K2 and K4 on every
    step they run (scan mode also steps the bad frame)."""
    from rt3d_torch.runtime import PipelineDriver

    pipe, src = _small_pipeline()
    runs = {}
    for name, kw, steps in (("depth1", dict(pipeline_depth=1), 4),
                            ("depth2", dict(pipeline_depth=2), 4),
                            ("scan2", dict(frames_per_dispatch=2), 5)):
        seen = []
        kernels.reset_launches()
        res = PipelineDriver(pipe, **kw).run(_BadFrame(src, 2), 5, warmup=1,
                                             on_frame=lambda i, o: seen.append((i, o)))
        torch.cuda.synchronize()
        assert res.skipped_frames == 1 and [i for i, _ in seen] == [0, 1, 3, 4]
        for k, per in (("window_dedupe", 2), ("window_prev_or", 2), ("min_sqdist", 1)):
            assert kernels.LAUNCHES[k] == per * steps, (name, k)
        runs[name] = seen
    for name in ("depth2", "scan2"):
        for (_, a), (_, b) in zip(runs[name], runs["depth1"]):
            assert torch.equal(a.detections.boxes, b.detections.boxes), name
            assert torch.equal(a.track_ids, b.track_ids), name
            assert torch.equal(a.objects.points, b.objects.points), name
            assert torch.equal(a.workspace.valid, b.workspace.valid), name


def test_profile_op_times_on_card(gen):
    from rt3d_torch.runtime import profile_op_times

    x = torch.rand(1 << 20, device="cuda", generator=gen)
    total, per_op = profile_op_times(lambda: (x * 2).sum(), iters=3)
    assert total > 0 and per_op and all(v >= 0 for v in per_op.values())


@pytest.mark.parametrize("capacity", [1 << 20, 4096])
def test_accumulate_voxels_on_card_equals_cpu(gen, capacity):
    """Three frames of 1 mm voxels (200 000 rays each, many sharing a
    voxel) folded into the accumulator on the card and on the CPU, without
    eviction and with it (4096 voxels): keys and overflow equal, weights
    within 1e-6 relative; the extracted voxels equal outside that band of
    the weight threshold."""
    from rt3d_torch.geometry.voxel_sets import (
        VoxelAccumulator, accumulate_voxels, extract_accumulated,
    )

    accs = {d: VoxelAccumulator.empty(capacity, d) for d in ("cuda", "cpu")}
    for _ in range(3):
        pts = (torch.randint(-300, 300, (200000, 3), device="cuda", generator=gen).float()
               * 0.0007).contiguous()
        valid = torch.rand(200000, device="cuda", generator=gen) >= 0.2
        ovf = {}
        for d in accs:
            accs[d], ovf[d] = accumulate_voxels(accs[d], pts.to(d), valid.to(d), 0.001,
                                                decay=0.97)
        assert int(ovf["cuda"]) == int(ovf["cpu"])
        assert (int(ovf["cuda"]) > 0) == (capacity == 4096)
    g, c = accs["cuda"], accs["cpu"]
    assert torch.equal(g.keys_hi.cpu(), c.keys_hi) and torch.equal(g.keys_lo.cpu(), c.keys_lo)
    torch.testing.assert_close(g.weight.cpu(), c.weight, rtol=1e-6, atol=0)
    band = (c.weight - 0.5).abs() <= 0.5e-6
    ge, ce = extract_accumulated(g, 0.001, min_weight=0.5), extract_accumulated(c, 0.001,
                                                                                min_weight=0.5)
    assert torch.equal(ge.valid.cpu()[~band], ce.valid[~band])
    assert torch.equal(ge.points.cpu()[~band], ce.points[~band])


# (cin, cout, k, stride, groups, hw): x's stage-1 conv, its K = 6912 conv,
# a depthwise `pe` conv, and shapes the int8 GEMM pads (K 27 and cout 6;
# 12 rows)
QCONVS = [(96, 192, 3, 2, 1, (96, 160)), (768, 768, 3, 2, 1, (24, 40)),
          (384, 384, 3, 1, 384, (12, 20)), (3, 6, 3, 2, 1, (5, 6)), (64, 40, 1, 1, 1, (2, 3))]


@pytest.mark.parametrize("cin,cout,k,s,g,hw", QCONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_conv_on_card_equals_cpu(gen, cin, cout, k, s, g, hw, dtype):
    """`QConv` on the card against the same module on the CPU: the int8
    input and the int32 sums the same integers (cuBLASLt's int8 GEMM, or the
    depthwise tap sum), the output within 1e-6 in f32 (the two devices'
    sigmoids may differ by an ulp) and one bf16 ulp in bf16."""
    import copy

    from rt3d_torch.models.yolo import QConv

    cpu_gen = torch.Generator().manual_seed(cin + cout)
    conv = QConv(cin, cout, k, s, g)
    with torch.no_grad():
        conv.weight.copy_(torch.randint(-127, 128, conv.weight.shape, generator=cpu_gen)
                          .to(torch.int8))
        conv.kernel_scale.copy_(torch.rand(cout, generator=cpu_gen) * 0.02 + 1e-3)
        conv.act_scale.fill_(3.0)
        conv.bias.copy_(torch.randn(cout, generator=cpu_gen))
    x = (torch.randn(2, cin, *hw, generator=cpu_gen) * 1.5).to(dtype)
    card = copy.deepcopy(conv).cuda()
    xc = x.cuda().contiguous(memory_format=torch.channels_last)
    xq, xq_card = conv.quantize_input(x), card.quantize_input(xc)
    assert torch.equal(xq_card.cpu(), xq)
    acc, acc_card = conv.int_conv(xq), card.int_conv(xq_card)
    assert acc_card.dtype == torch.int32 and acc_card.is_cuda
    assert torch.equal(acc_card.cpu(), acc)
    y, yc = conv(x, act=True), card(xc, act=True)
    assert yc.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(yc.cpu(), y, rtol=tol, atol=tol)
