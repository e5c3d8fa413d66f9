"""Point Transformer V3 in the port (``models/ptv3.py``, ``ops/serialize.py``,
``ops/patch_attention.py``, the kernel-5 stem map and conv) on the CPU, held
against the benchmark's plain reference (``lidal_bench/reference/ptv3.py``,
which shares no code with the port) on tiny scan-like frames.

Held: z codes are the bit interleave; Hilbert codes are a bijection of the
2^d cube whose consecutive codes are face neighbours, and codes >> 3 group
the fine voxels exactly as ``DownPlan.parent``; both curves equal the
reference's; patches are padded and un-padded by Pointcept's rule; the
pooling is a segment max; logits, loss and every gradient of a train-mode
forward, and three Adam steps, with drop path and order shuffles drawn from
the seeds, match the reference (f32 sums in another order through 22
blocks: logits within 1e-4 of their largest value, each gradient within
5e-3 of its norm (1.4e-3 read), the Adam steps' changes within 1e-2 of the
larger of the leaf's and the median leaf's (2.5e-3 read: Adam's first steps
are sign-like and amplify rounding));
``run_train`` runs with ``model_name="PTv3"``; a fused round reaches a
selection; the spans and counters are recorded and the counters equal the
patch arithmetic (one attention call a block; on the CPU no kernel launch
is counted, under a backward neither).  On a card (``-m cuda``): the 125-tap conv's forward and
backward against the plain versions.

This module imports no JAX at import time (the card runs its ``cuda`` test
with ``--noconftest``); the fused round's fixture builds its tree with the
JAX package's prep, as ``tests/test_torch_round.py`` does.
"""

import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from lidal_bench.reference import data as rdata, ptv3 as rptv3
from lidal_bench.reference.model import Maps
from lidal_bench.reference.train import prepare
from lidal_bench.traffic import scan
from lidal_tpu_torch.config import DataConfig, RunConfig
from lidal_tpu_torch.data.augment import sample_augment
from lidal_tpu_torch.data.pipeline import forward_batch, prepare_train_batch
from lidal_tpu_torch.models import ptv3
from lidal_tpu_torch.ops import conv, patch_attention as pa, serialize
from lidal_tpu_torch.ops.kernel_map import OFFSETS5, build_down, build_subm5_nbr_batched
from lidal_tpu_torch.ops.voxelize import unique_voxels
from lidal_tpu_torch.runtime import train_loop
from lidal_tpu_torch.runtime.train import cross_entropy_ignore, make_optimizer, train_step, TrainState
from lidal_tpu_torch.utils import profiling

CAPS = (2048, 1024, 512, 256, 128)
POINT_CAP = 2048
SCAN = {"scene_seed": 7, "beams": 8, "azimuths": 256, "elev_top_deg": 2.0, "elev_bottom_deg": -24.9,
        "mount_height_m": 1.73, "max_range_m": 80.0, "range_noise_m": 0.02, "dropout": 0.08, "step_m": 1.0,
        "yaw_drift_deg": 0.3, "road_half_m": 4.0, "sidewalk_m": 3.0}
CFG = {"num_classes": 19, "in_channels": 4, "scale": 20.0, "full_scale": 8192, "point_cap": POINT_CAP,
       "level_caps": CAPS, "batch_size": 2}


@pytest.fixture
def few_threads(monkeypatch):
    """Two threads, and patches of at most 128 tokens on both sides (the
    frames' smallest counts still set the coarse levels' patches)."""
    monkeypatch.setattr(ptv3, "PATCH", 128)
    monkeypatch.setattr(rptv3, "PATCH", 128)
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ptv3_frames"))
    frames, poses = scan.generate(11, 6, SCAN, torch.device("cpu"))
    return rdata.frame_files(scan.write_sequence(os.path.join(root, "sequences"), "00", frames, poses), "00")


# -- serialization ------------------------------------------------------------
def test_z_code_is_the_bit_interleave():
    c = torch.randint(0, 1 << 13, (500, 3))
    want = torch.zeros(500, dtype=torch.int64)
    for i in range(13):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            want |= ((c[:, axis] >> i) & 1) << (3 * i + shift)
    assert torch.equal(serialize.z_code(c), want)
    assert torch.equal(serialize.curve_code(c, 13, "z-trans"), serialize.z_code(c[:, [1, 0, 2]]))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_hilbert_code_is_a_face_adjacent_bijection(depth):
    side = 1 << depth
    c = torch.tensor(list(itertools.product(range(side), repeat=3)))
    code = serialize.hilbert_code(c, depth)
    assert sorted(code.tolist()) == list(range(side ** 3))
    walk = c[torch.argsort(code)]
    assert torch.equal((walk[1:] - walk[:-1]).abs().sum(1), torch.ones(side ** 3 - 1, dtype=torch.int64))
    assert torch.equal(code, rptv3.hilbert_code(c, depth))
    assert torch.equal(serialize.z_code(c), rptv3.z_code(c, depth))


@pytest.mark.parametrize("order", serialize.ORDERS)
def test_codes_shifted_by_three_group_the_coarse_level(order):
    g = torch.Generator().manual_seed(3)
    coords = torch.randint(0, 200, (2, 1500, 3), generator=g).int()
    valid = torch.rand(2, 1500, generator=g) < 0.9
    uv = unique_voxels(coords, valid, 1500)
    cuv, down = build_down(uv.coords, uv.valid, 1024)
    depth = serialize.depth_of(int(uv.coords[uv.valid].max()))
    code = torch.where(uv.valid, serialize.curve_code(uv.coords, depth, order), -1) >> 3
    for b in range(2):
        n = int(uv.valid[b].sum())
        parent = down.parent[b, :n]
        kept = parent < 1024
        pairs = set(zip(code[b, :n][kept].tolist(), parent[kept].tolist()))
        assert len(pairs) == len({p for _, p in pairs}) == len({c for c, _ in pairs})  # a bijection of groups
    codes = serialize.level_codes(uv.coords, uv.valid, [down], [cuv.valid], depth)
    o = serialize.ORDERS.index(order)
    coarse = codes[1][o]
    assert torch.equal(coarse.gather(1, torch.where(down.parent < 1024, down.parent, 0).long())[uv.valid
                       & (down.parent < 1024)], code[uv.valid & (down.parent < 1024)])


def test_order_inverse_and_perms():
    codes = torch.tensor([[5, 1, serialize.LAST, 3], [2, serialize.LAST, serialize.LAST, 0]])
    order, inverse = serialize.sort_orders(codes)
    assert order.tolist() == [[1, 3, 0, 2], [3, 0, 1, 2]]
    assert torch.equal(order.gather(1, inverse), torch.arange(4).expand(2, 4))
    perms = serialize.order_perms(2**40 + 1, 5)
    assert perms == rptv3.order_perms(2**40 + 1, 5) and all(sorted(p) == [0, 1, 2, 3] for p in perms)


# -- patches ------------------------------------------------------------------
@pytest.mark.parametrize("counts", [[2500, 1300, 3000], [1024, 700], [5, 9, 0], [4096, 2048]])
def test_pad_and_unpad_follow_pointcept(counts):
    cap = 4096
    lay = pa.patch_layout(counts, cap, 1024, "cpu")
    want_pad, want_unpad, k = rptv3.padding(counts, False)
    assert lay.k == k and lay.tokens == len(want_pad) and lay.patches * k == lay.tokens
    assert lay.pad_tokens == len(want_pad) - sum(counts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    frame = np.searchsorted(starts, want_pad.numpy(), side="right") - 1
    flat = frame * cap + (want_pad.numpy() - starts[frame])  # Pointcept's index in the port's [B * cap] rows
    assert lay.src.tolist() == flat.tolist()
    order = torch.arange(cap).expand(len(counts), cap)
    valid = torch.arange(cap)[None] < torch.tensor(counts)[:, None]
    idx = pa.order_index(lay, order, order, valid)
    assert idx.unpad[valid.reshape(-1)].tolist() == want_unpad.tolist()
    assert bool((idx.unpad[~valid.reshape(-1)] == lay.tokens).all())


def test_pooling_is_a_segment_max():
    g = torch.Generator().manual_seed(4)
    coords = torch.randint(0, 40, (2, 800, 3), generator=g).int()
    uv = unique_voxels(coords, torch.ones(2, 800, dtype=torch.bool), 800)
    cuv, down = build_down(uv.coords, uv.valid, 400)
    pool = ptv3.Pooling(8, 16)
    x = torch.randn(2, 800, 8, generator=g)
    h = pool.proj(x)
    want = torch.full((2, 401, 16), -torch.inf)
    for b in range(2):
        rows = uv.valid[b] & (down.parent[b] < 400)
        want[b] = want[b].scatter_reduce(0, down.parent[b][rows].long()[:, None].expand(-1, 16), h[b][rows], "amax")
    want = torch.where(cuv.valid[..., None], want[:, :400], 0.0)
    pool.norm.eval()
    with torch.no_grad():
        got = pool(x, down, cuv.valid)
        ref = torch.nn.functional.gelu(pool.norm(want, cuv.valid))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# -- the model against the reference -------------------------------------------
def _port_batch(paths, draws, device="cpu"):
    xyz, sig, valid, labels = (torch.from_numpy(a) for a in rdata.padded_batch(paths, POINT_CAP))
    return prepare_train_batch(None, xyz, sig, valid, labels, CAPS, draws=draws)


def _valid_rows(x, valid):
    return torch.cat([x[b][valid[b]] for b in range(x.shape[0])])


def test_stem_map_equals_the_reference(frames_dir):
    g = torch.Generator().manual_seed(1)
    draws = rdata.draw_augment(g, 2)
    tb = _port_batch(frames_dir[:2], sample_augment(torch.Generator().manual_seed(1), 2))
    _, _, frames = prepare(frames_dir[:2], draws, CFG, "cpu")
    mp = Maps(frames)
    want = rptv3.stem_map(frames, mp)
    valid = tb.plan.levels[0].valid
    nbr5 = build_subm5_nbr_batched(tb.plan.levels[0].coords, valid)
    got = torch.cat([torch.where(nbr5[b] < CAPS[0], nbr5[b].long() + mp.off[0][b], -1)[valid[b]]
                     for b in range(2)])
    assert torch.equal(got, want) and len(OFFSETS5) == 125 and nbr5.shape == valid.shape + (125,)


def test_forward_gradients_and_adam_steps_match_the_reference(frames_dir, few_threads):
    seed = 2**33 + 5
    model = ptv3.PTv3().train()
    with torch.device("meta"):
        shapes = rptv3.PTv3()
    weights = rptv3.seeded_weights(shapes, seed, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    state = TrainState(0, model, make_optimizer(model))
    gen = torch.Generator().manual_seed(seed)
    batches = [frames_dir[0:2], frames_dir[2:4], frames_dir[4:6]]
    ref = rptv3.run_steps(batches, weights, seed, CFG, "cpu", 3, keep_first=True)
    first = ref["first"]
    losses = []
    for k, paths in enumerate(batches):
        tb = _port_batch(paths, sample_augment(gen, 2))
        draws = train_loop.step_draws(gen, RunConfig(model_name="PTv3"), 2, 0, 2)
        assert isinstance(draws, ptv3.StepDraws)
        if k == 0:  # logits, loss and every gradient of the first step against the reference's
            logits, _ = forward_batch(model, tb, draws)
            loss = cross_entropy_ignore(logits, tb.labels)
            model.zero_grad()
            loss.backward()
            got = _valid_rows(logits.detach(), tb.plan.levels[0].valid)
            torch.testing.assert_close(got, first["logits"], rtol=0, atol=1e-4 * float(first["logits"].abs().max()))
            assert abs(float(loss) - first["loss"]) < 1e-5 * first["loss"]
            for n, p in model.named_parameters():
                want = first["grads"][n]
                if float(want.abs().max()) < 1e-6:  # a Linear bias in front of a BN: zero up to rounding
                    continue
                assert float((p.grad - want).norm()) < 5e-3 * float(want.norm()), n
            state.optimizer.zero_grad(set_to_none=True)
        losses.append(float(train_step(state, tb, draws)))
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    med = float(np.median(list(ref["delta"].values())))
    med_g = float(np.median(list(ref["grad1"].values())))
    for n, p in model.named_parameters():
        if ref["grad1"][n] < 1e-3 * med_g:
            continue  # moved by Adam from rounding alone
        assert abs(float((p.detach() - weights[n]).norm()) - ref["delta"][n]) < 1e-2 * max(ref["delta"][n], med), n


def test_the_shuffle_and_drop_path_change_the_step_and_eval_ignores_them(frames_dir, few_threads):
    torch.manual_seed(0)
    model = ptv3.PTv3().train()
    tb = _port_batch(frames_dir[:2], sample_augment(torch.Generator().manual_seed(2), 2))
    outs = {}
    for name, d in {"a": ptv3.StepDraws([1, 2], 3), "b": ptv3.StepDraws([1, 2], 4),
                    "c": ptv3.StepDraws([5, 2], 3)}.items():  # b: another shuffle; c: another drop path
        with torch.no_grad():
            outs[name] = forward_batch(model, tb, d)[0]
    assert not torch.equal(outs["a"], outs["b"]) and not torch.equal(outs["a"], outs["c"])
    model.eval()
    with torch.no_grad():
        e1 = forward_batch(model, tb, ptv3.StepDraws([1, 2], 3))[0]
        e2 = forward_batch(model, tb)[0]
    assert torch.equal(e1, e2)


def test_spans_and_counters_equal_the_patch_arithmetic(frames_dir, few_threads):
    torch.manual_seed(0)
    model = ptv3.PTv3().eval()
    tb = _port_batch(frames_dir[:2], sample_augment(torch.Generator().manual_seed(2), 2))
    profiling.reset()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        forward_batch(model, tb)
    spans, counters = profiling.stats()["spans"], profiling.stats()["counters"]
    per_level = [ptv3.ENC_DEPTHS[l] + (ptv3.DEC_DEPTHS[l] if l < 4 else 0) for l in range(5)]
    assert spans["ptv3.serialize"]["count"] == 1 and spans["ptv3.attention"]["count"] == sum(per_level)
    assert spans["ptv3.pool"]["count"] == 4 and spans["ptv3.unpool"]["count"] == 4
    counts = [tb.plan.levels[l].num_valid.tolist() for l in range(5)]
    patches = pads = 0
    for l, n in enumerate(counts):
        k = min([ptv3.PATCH] + [c for c in n if c > 0])
        padded = sum(-(-c // k) * k for c in n)
        patches += per_level[l] * padded // k
        pads += per_level[l] * (padded - sum(n))
    assert counters["ptv3.patches"] == patches and counters["ptv3.pad_tokens"] == pads
    assert counters["launch.patch_attention"] == sum(per_level)
    kernels = ("launch.attn_fwd", "launch.attn_bwd")  # kernel launches: none on the CPU
    assert not any(n in counters for n in kernels)
    forward_batch(model, tb)[0].sum().backward()  # the plain backward of every block's attention
    counters = profiling.stats()["counters"]
    assert counters["launch.patch_attention"] == 2 * sum(per_level) and not any(n in counters for n in kernels)


def test_run_train_takes_ptv3(frames_dir, tmp_path, few_threads):
    data = DataConfig(name="SK", num_classes=19, batch_size=2, point_cap=POINT_CAP, level_caps=CAPS,
                      train_split=("00",), val_split=())
    cfg = RunConfig(model_name="PTv3", seed=3, data_root=os.path.dirname(os.path.dirname(frames_dir[0])),
                    processing_root=str(tmp_path / "p"), checkpoint_root=str(tmp_path / "c"), data_override=data)
    from lidal_tpu_torch.data.loader import FrameBatchLoader

    loader = FrameBatchLoader(frames_dir, train_loop.make_sk_read_fn(cfg), point_cap=POINT_CAP, batch_size=2,
                              shuffle=True, seed=3)
    losses = []
    state = train_loop.run_train(cfg, loader=loader, max_iter=2, on_step=lambda s, l: losses.append(float(l)),
                                 device="cpu")
    assert isinstance(state.model, ptv3.PTv3) and state.step == 2 and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(str(tmp_path / "c"), "SK", "PTv3"))


@pytest.fixture(scope="module")
def round_tree(tmp_path_factory):
    """The mini tree of ``tests/test_torch_round.py``, prepared by the JAX package."""
    from tests import test_torch_round as tr

    root = str(tmp_path_factory.mktemp("ptv3_round"))
    tr.make_mini_sk(root, seqs=tr.SEQS, frames_per_seq=tr.FRAMES, points=tr.N_SEEN)
    tr._static_world_frames(root, seed=1)
    jcfg = tr.mini_cfg(root, seqs=tr.SEQS, r_id=1,
                       data_kw={"train_point_num": len(tr.SEQS) * tr.FRAMES * tr.N_SEEN * 12})
    seq_frames = {s: tr.jax_sk.list_frames(jcfg.data_root, [s]) for s in tr.SEQS}
    tr.prepare_supervoxels_kmeans(jcfg, seq_frames, lambda p: tr.jax_sk.read_frame(p, with_labels=False)[0],
                                  n_clusters=6)
    tr.jax_prepare_sk_grids(jcfg)
    tr.jax_bootstrap_round0(jcfg, seq_frames)
    for s in tr.SEQS:
        svdir = tr.JaxPaths(jcfg).sv_flag_dir(s, r_id=0)
        for i, name in enumerate(sorted(os.listdir(svdir))):
            flags = np.load(os.path.join(svdir, name))
            flags[:] = int(i == 0)
            np.save(os.path.join(svdir, name), flags)
    return tr, root, jcfg


def test_fused_round_with_ptv3_reaches_a_selection(round_tree, tmp_path, few_threads):
    from lidal_tpu_torch.active import lidal_runner
    from lidal_tpu_torch.runtime.paths import Paths

    tr, root, jcfg = round_tree
    cfg = tr.port_cfg(tr._relocated(jcfg, tr._copy_tree(root, tmp_path / "fused")), r_id=2, inf_reps=1,
                      view_chunk=1, model_name="PTv3")
    for s in tr.SEQS:
        shutil.copytree(Paths(cfg).sv_flag_dir(s, r_id=0), Paths(cfg).sv_flag_dir(s, r_id=1))
    torch.manual_seed(5)
    model = train_loop.build_model(cfg).eval()
    before = profiling.counter("launch.patch_attention")
    res = lidal_runner.run_fused_lidal_round(cfg, model, tr._read_raw(cfg), save_prob=False, device="cpu")
    assert len(res.al_added) > 0 and int(res.sv_flags.sum()) > 0
    assert profiling.counter("launch.patch_attention") > before


# -- on the card -------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("cin,need_dx", [(4, False), (32, True)], ids=["stem", "with_dx"])
def test_wide_conv_on_the_card_matches_the_plain_versions(cin, need_dx):
    """A 125-tap conv (5 launches of the 27-tap kernels) forward, weight
    gradient and, for cin = 32, input gradient against the CPU's plain
    versions (the stem's cin = 4 takes no input gradient: the kernel's dx
    needs 32 columns), within 1e-4 of each result's largest value (sums of
    up to 125 x cin products in another order; the kernels' split TF32 keeps
    f32 accuracy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    coords = torch.randint(0, 60, (2, 20000, 3), generator=g).int()
    uv = unique_voxels(coords, torch.ones(2, 20000, dtype=torch.bool), 20000)
    nbr = build_subm5_nbr_batched(uv.coords, uv.valid)
    assert torch.equal(build_subm5_nbr_batched(uv.coords.cuda(), uv.valid.cuda()).cpu(), nbr)
    x = torch.randn(2, 20000, cin, generator=g) * uv.valid[..., None]
    w = torch.randn(125, cin, 32, generator=g) * 0.1
    dy = torch.randn(2, 20000, 32, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        xd, wd = x.detach().to(dev).requires_grad_(need_dx), w.detach().to(dev).requires_grad_(True)
        y = conv.subm_conv_batched(xd, wd, nbr.to(dev))
        y.backward(dy.to(dev))
        out[dev] = [t.detach().cpu() for t in (y, wd.grad) + ((xd.grad,) if need_dx else ())]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
