"""Segment Anything as the step's mask model (`rt3d_torch.models.sam`, and
`Pipeline.detect` and `Pipeline.masks` with SAM) against the benchmark's plain
float32 reference (`bench_port/reference/models/sam.py`,
`bench_port/reference/pipeline/sam_step.py`), on the CPU at a tiny size
(width 64, depth 4, 4 heads, global blocks 1 and 3, window 4 over a 10 x 10
grid padded to 12 x 12, image 160, prompt width 32) with seeded random
weights, both sides in float32.

Tolerances. Both sides compute in float32; they differ in the order of
their sums (the program's fused `scaled_dot_product_attention` and
`layer_norm` against the reference's matmul, softmax and hand-written
LayerNorm2d), which moves a result by a few float32 roundings, about 1e-6
relative. `REL` (1e-5) leaves that ten times over. The benchmark's FP8
control (each encoder Linear weight rounded through float8 e4m3) moves the
embeddings by about 1e-2 relative, and bf16 by about 1e-3, so either fails
`REL`: `test_fp8_control_and_faults_fail_the_tolerance` holds that, and that
dropping the global blocks' relative position terms fails it too (a fault
that the benchmark's cell cannot tell from bf16's rounding).

The step tests run one frame on one thread: the module is one of many that
the suite runs side by side on a few cores."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bench_port import check, drive, spec
from bench_port.synthetic import EasyScene
from bench_port.reference import config as rconfig
from bench_port.reference.models import sam as R
from bench_port.reference.pipeline.sam_step import SamPipeline
from bench_port.reference.pipeline.step import build_pipeline as rbuild_pipeline
from rt3d_torch import config
from rt3d_torch.io import SyntheticSource
from rt3d_torch.models import sam as P
from rt3d_torch.pipeline.step import build_pipeline, index_outputs
from rt3d_torch.runtime import trace
from tests.tiny import tiny_config

H, W = 240, 320
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "yolo11n_synth_seg.npz")
TINY = dict(image_size=160, patch_size=16, embed_dim=64, depth=4, num_heads=4, mlp_dim=256,
            window_size=4, global_attn_indexes=[1, 3], prompt_embed_dim=32, decoder_depth=2,
            decoder_heads=4, decoder_mlp_dim=64, attention_downsample_rate=2,
            num_multimask_outputs=3, iou_head_depth=3, iou_head_hidden_dim=32, mask_in_chans=16,
            layer_norm_eps=1e-6)
SEED = 20304
REL = 1e-5
SAM_ARCH = spec.architecture("sam_vit_h")


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module", autouse=True)
def tiny_sizes():
    """The program's table of sizes holds the tiny model as "sam_test";
    torch runs on one thread meanwhile."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(P.SAM_SIZES, "test", P.SamSizes(**{
                **TINY, "global_attn_indexes": tuple(TINY["global_attn_indexes"])}))
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def models():
    return (P.build_sam("sam_test", torch.float32, "cpu", seed=SEED),
            R.build_sam(R.SamSizes.from_dict(TINY), "cpu", seed=SEED))


@pytest.fixture(scope="module")
def images():
    gen = torch.Generator().manual_seed(5)
    rgb = torch.randint(0, 256, (2, 90, 160, 3), dtype=torch.uint8, generator=gen)
    return rgb


def boxes():
    """Two cameras' box slots in the encoder's input pixels: ordinary boxes,
    one over the image's edge and one degenerate (an invalid slot)."""
    return torch.tensor([[[10.0, 12.0, 80.0, 60.0], [0.0, 0.0, 0.0, 0.0],
                          [100.0, 40.0, 170.0, 95.0]],
                         [[30.5, 20.25, 150.0, 80.0], [5.0, 5.0, 9.0, 7.0],
                          [60.0, 0.0, 61.0, 89.0]]])


def test_init_rule_gives_the_references_tensors(models):
    prog, ref = models
    sp, sr = prog.state_dict(), ref.state_dict()
    assert sorted(sp) == sorted(sr)
    for k in sp:
        assert torch.equal(sp[k], sr[k]), k
    for k, t in sp.items():
        if t.dim() == 1:
            assert torch.all(t == (0.0 if k.endswith("bias") else 1.0)), k
    big = [t for k, t in sp.items() if t.dim() >= 2 and t.numel() > 1000]
    assert all(0.015 < float(t.std()) < 0.025 for t in big)
    assert 0.7 < float(sp["mask_decoder.mask_tokens.weight"].std()) < 1.3


def test_public_key_names_load_into_both(tmp_path, models):
    """A checkpoint under the public names (as `sam_vit_h_4b8939.pth` holds
    them) loads whole into the program and the reference."""
    other = R.build_sam(R.SamSizes.from_dict(TINY), "cpu", seed=SEED + 1)
    sd = {k: v.clone() for k, v in other.state_dict().items()}
    assert {k.split(".")[0] for k in sd} == {"image_encoder", "prompt_encoder", "mask_decoder"}
    path = str(tmp_path / "sam_test.pth")
    torch.save(sd, path)
    prog = P.build_sam("sam_test", torch.float32, "cpu", weights=path)
    ref = R.build_sam(R.SamSizes.from_dict(TINY), "cpu", weights=path)
    for m in (prog, ref):
        got = m.state_dict()
        assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


def test_preprocess_matches_reference(models, images):
    prog, ref = models
    x = prog.preprocess(images)
    assert x.shape == (2, 3, 160, 160) and prog.input_hw((90, 160)) == (90, 160)
    assert rel(x, ref.preprocess(images)) < REL
    assert torch.all(x[:, :, 90:] == 0)


@pytest.mark.parametrize("block", [0, 1])  # block 0 attends in windows, block 1 globally
def test_attention_blocks_match_reference(models, images, block):
    prog, ref = models
    x = torch.randn((2, 10, 10, 64), generator=torch.Generator().manual_seed(block))
    assert prog.image_encoder.blocks[block].window_size == (0 if block == 1 else 4)
    assert rel(prog.image_encoder.blocks[block](x), ref.image_encoder.blocks[block](x)) < REL


def test_encoder_matches_reference(models, images):
    prog, ref = models
    x = ref.preprocess(images)
    assert rel(prog.image_encoder(x), ref.image_encoder(x)) < REL


def test_prompt_encoder_matches_reference(models):
    prog, ref = models
    b = boxes().reshape(-1, 4)
    sparse, dense = ref.prompt_encoder(b)
    assert rel(prog.prompt_encoder.embed_boxes(b), sparse) < REL
    assert rel(prog.dense_pe(), ref.prompt_encoder.get_dense_pe()) < REL
    assert torch.equal(dense[0, :, 0, 0], prog.prompt_encoder.no_mask_embed.weight[0])


def test_decoder_logits_and_iou_match_reference(models, images):
    prog, ref = models
    emb = ref.image_encoder(ref.preprocess(images))
    low, iou = prog.decode_boxes(emb, boxes())
    assert low.shape == (2, 3, 40, 40) and iou.shape == (2, 3)
    for c in range(2):
        r_low = ref.low_res_logits(emb[c:c + 1], boxes()[c])[:, 0]
        r_iou = ref.iou_predictions(emb[c:c + 1], boxes()[c])[:, 0]
        for i in range(3):
            assert rel(low[c, i], r_low[i]) < REL
        assert rel(iou[c], r_iou) < REL


def rel_pos_dropped(pipe):
    """The global blocks' attention loses the relative position terms."""
    for i in pipe.sam.sizes.global_attn_indexes:
        pipe.sam.image_encoder.blocks[i].attn.use_rel_pos = False


def test_fp8_control_and_faults_fail_the_tolerance(models, images):
    """The benchmark's control and faults of SAM, and the global blocks'
    relative position terms dropped, on the program's SAM of a pipeline,
    move the embeddings out of `REL`."""
    _, ref = models
    x = ref.preprocess(images)
    want = ref.image_encoder(x)
    breaks = dict(SAM_ARCH.FAULTS, control=lambda pipe: SAM_ARCH.control(pipe, None, None, None),
                  rel_pos_dropped=rel_pos_dropped)
    for name, brk in breaks.items():
        pipe = dataclasses.make_dataclass("Pipe", ["sam"])(
            P.build_sam("sam_test", torch.float32, "cpu", seed=SEED))
        brk(pipe)
        assert rel(pipe.sam.image_encoder(x), want) > 10 * REL, name


# -- the step -------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame():
    p = SyntheticSource(num_cameras=2, num_frames=1, hw=(H, W), num_objects=2).get(0)
    return p.rgb, p.depth


def sam_config(mask_model="sam_test") -> config.Config:
    """`tests/test_torch_step.py`'s config (n model at (192, 256), float32)
    with the tiny SAM as its mask model."""
    d = tiny_config().to_dict()
    cams = SyntheticSource(num_cameras=2, num_frames=1, hw=(H, W), num_objects=2).cameras()
    d["rig"] = {"cameras": [dataclasses.asdict(c) for c in cams]}
    d["model"].update(input_hw=(192, 256), compute_dtype="float32",
                      preprocess_dtype="float32", mask_resize_dtype="float32",
                      mask_model=mask_model, sam_seed=SEED)
    return config.Config.from_dict(d)


@pytest.fixture(scope="module")
def pipe():
    return build_pipeline(sam_config(), weights=WEIGHTS, device="cpu")


@pytest.fixture(scope="module")
def ref(pipe):
    d = pipe.cfg.to_dict()
    own = {k: d["model"].pop(k) for k in config.MASK_FIELDS if k in d["model"]}
    rcfg = rconfig.Config.from_dict(d)
    yolo = rbuild_pipeline(rcfg, weights=WEIGHTS, device="cpu")
    assert own["mask_model"] == "sam_test"
    return SamPipeline(cfg=rcfg, model=yolo.model, device=yolo.device,
                       sam=R.build_sam(R.SamSizes.from_dict(TINY), "cpu", seed=own["sam_seed"]))


@pytest.fixture(scope="module")
def stepped(pipe, frame):
    """One traced step from the initial state: (state after, outputs,
    its record)."""
    trace.enable()
    try:
        state, out = pipe.step(pipe.init_state(), *(torch.from_numpy(a) for a in frame),
                               pipe.calib())
        return state, out, trace.records()[-1]
    finally:
        trace.disable()
        trace.clear()


def test_masks_stage_cuts_to_box_and_validity(pipe, ref, frame, stepped):
    """`masks` with SAM against the reference's SAM mask stage, on the program's
    detections and the reference's embeddings: equal but for pixels whose
    float32 logit rounds across 0, none outside a box or in an invalid slot."""
    det = stepped[1].detections
    assert int(det.valid.sum()) >= 2
    emb = ref.sam.image_encoder(ref.sam.preprocess(torch.from_numpy(frame[0])))
    got, low = pipe.masks(emb, det)
    want = ref.masks(emb, det)
    assert got.shape == want.shape == (2, 4, H, W)
    assert float((got != want).float().mean()) < 1e-4
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    for c in range(2):
        for i in range(4):
            x1, y1, x2, y2 = det.boxes[c, i].tolist()
            inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
            assert not bool((got[c, i] & ~inside).any())
            if not bool(det.valid[c, i]):
                assert not bool(got[c, i].any())
    assert bool(got[det.valid].any())
    assert rel(low, ref.low_res_logits(emb, det.boxes)) < REL


def test_sam_step_matches_the_reference_pipeline(ref, frame, stepped):
    """The step against the reference, stage by stage, as the benchmark
    judges a frame (`bench_port.check`), with SAM's logits compared too."""
    state, out, _ = stepped
    numbers = check.compare([drive.Kept(0, None, state, out)], lambda g: frame, ref,
                            SAM_ARCH.ExtraNumbers())
    assert numbers["sam_logit_rel_med"] < REL and numbers["sam_logit_off_share"] == 0.0
    assert numbers["obj_voxels"] < 1e-3
    assert numbers["det_unpaired"] == 0 and numbers["score_max"] == 0.0
    for k in ("track_ids_diff", "tracker_state_diff", "fused_diff", "workspace_diff",
              "accum_diff"):
        assert numbers[k] == 0, k
    assert out.low_res_logits.shape == (2, 4, 40, 40)
    assert int(out.per_camera_objects.valid.sum()) > 0


def test_sam_spans_nest_and_count(stepped):
    """`sam.preprocess` and `sam.encoder` under `YOLO11 Inference`,
    `sam.decoder` and `sam.postprocess` under `Mask Processing`; the counts
    C and C x max_detections; no device span on the CPU."""
    rec = stepped[2]
    spans = rec["spans"]

    def group(s):  # the span's ancestor right under the root `step`
        while spans[s.parent].parent is not None:
            s = spans[s.parent]
        return s.name

    sam = {s.name: group(s) for s in spans if s.name.startswith("sam.")}
    assert sam == {"sam.preprocess": "YOLO11 Inference", "sam.encoder": "YOLO11 Inference",
                   "sam.decoder": "Mask Processing", "sam.postprocess": "Mask Processing"}
    assert rec["counts"]["sam_encoder_images"] == 2
    assert rec["counts"]["sam_prompt_slots"] == 2 * 4
    assert rec["device_ms"] == {}


def test_device_span_is_off_untraced_and_plain_on_the_cpu():
    assert trace.device_span("sam.encoder", torch.device("cpu")) is trace.span("x")
    trace.enable()
    try:
        with trace.step(False):
            with trace.device_span("sam.encoder", torch.device("cpu")):
                pass
        rec = trace.records()[-1]
    finally:
        trace.disable()
    assert [s.name for s in rec["spans"]] == ["step", "sam.encoder"]
    assert rec["device_ms"] == {}


def test_proto_path_publishes_no_sam(pipe, frame):
    """The default mask model builds no SAM; the proto path runs no `sam.*`
    span, counts nothing of SAM and publishes no logits, and stacked and
    indexed outputs carry the None through."""
    assert config.ModelConfig().mask_model == "proto"
    assert build_pipeline(sam_config("proto"), device="cpu").sam is None
    proto = dataclasses.replace(pipe, sam=None)
    rgb, depth = (torch.from_numpy(a)[None] for a in frame)
    trace.enable()
    state, out = proto.step_scan(proto.init_state(), rgb, depth, proto.calib(), [True])
    rec = trace.records()[-1]
    assert out.low_res_logits is None and index_outputs(out, 0).low_res_logits is None
    assert not any(s.name.startswith("sam.") for s in rec["spans"])
    assert rec["counts"]["sam_encoder_images"] == rec["counts"]["sam_prompt_slots"] == 0


def _tensors(tree):
    """The tensors of a tree of `FrameOutputs` and its dataclasses, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]


def test_sharded_step_at_world_one_runs_sam(pipe, frame, stepped):
    """`make_sharded_step` over one gloo rank takes SAM's masks through
    `detect` and `masks` as the step does: its outputs, SAM's logits among
    them, are the step's bit for bit."""
    import torch.distributed as dist

    from rt3d_torch.parallel.multicam import make_sharded_step

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        sharded = make_sharded_step(pipe)
        _, out = sharded(sharded.init_state(), *(torch.from_numpy(a) for a in frame),
                         sharded.calib())
    finally:
        dist.destroy_process_group()
    want = _tensors(stepped[1])
    got = _tensors(out)
    assert out.low_res_logits is not None and len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sam_pipeline_hands_the_frames_to_detect(pipe, frame):
    """With SAM, `preprocess` gives the detector's input and the frames;
    `detect` refuses the detector's input alone; calibration batches are
    the detector's input."""
    from rt3d_torch.models import quant

    rgb = torch.from_numpy(frame[0])
    x = pipe.preprocess(rgb)
    assert x.rgb is rgb and x.images.shape == (2, 192, 256, 3)
    with pytest.raises(TypeError, match="SamInput"):
        pipe.detect(x.images)
    src = SyntheticSource(num_cameras=2, num_frames=1, hw=(H, W), num_objects=2)
    (batch,) = quant.synth_calib_batches(pipe, src, (0,))
    assert torch.equal(batch, x.images)


def test_unknown_mask_model_is_refused():
    with pytest.raises(ValueError, match="unknown mask_model"):
        build_pipeline(sam_config("sam_vit_z"), weights=WEIGHTS, device="cpu")


# -- the benchmark's SAM configuration -------------------------------------------

MS = 1_000_000  # ns
# YOLO11x-seg at 384 x 640 (`bench_port/tests/test_bench_port_arch.py`), SAM
# ViT-H's encoder, and one box prompt through its decoder
X_FLOPS, ENCODER_FLOPS, DECODER_FLOPS = 177817374720, 5961082830848, 3622604800
SAM_CELL = "sam_vit_h_yolo11x_2cam_5mm.objects6"


def test_flops_are_pinned():
    conf = spec.workload(SAM_CELL)["config_spec"]
    assert conf["sam"] == SAM_ARCH.VIT_H
    assert SAM_ARCH.encoder_flops(conf["sam"]) == ENCODER_FLOPS  # 5.96 TFLOP
    assert SAM_ARCH.decoder_flops(conf["sam"]) == DECODER_FLOPS
    assert SAM_ARCH.flops_per_image(conf) == X_FLOPS + ENCODER_FLOPS + 20 * DECODER_FLOPS


def test_the_program_runs_the_stated_sam_config():
    """The program's config of the SAM cell holds every stated field at the
    stated value, SAM's fields among them; its ViT-H has the file's sizes;
    SAM's fault joins the common ones."""
    from bench_port import faults

    cell = spec.workload(SAM_CELL)
    conf, t = cell["config_spec"], cell["traffic"]
    cams = EasyScene(t["cameras"], t["objects"], t["scene_seed"], tuple(t["hw"])).cameras()
    cfg = spec.make_config(config, conf, cams)
    assert spec.config_differences(cfg, SAM_ARCH.stated_config(conf, cams)) == ([], [])
    assert (cfg.model.mask_model, cfg.model.sam_seed) == ("sam_vit_h", 20304)
    SAM_ARCH.check_program(cfg, conf)
    with pytest.raises(ValueError, match="window_size"):
        SAM_ARCH.check_program(cfg, dict(conf, sam=dict(conf["sam"], window_size=16)))
    planted = faults.for_cell(cell)
    assert {"sam_global_windowed", "detections_dropped"} <= set(planted)
    assert not any("rel_pos" in name for name in planted)


def _steps(images):
    """Six program steps 20 ms apart, each with a 25 ms device span of
    SAM's encoder over `images` images; the harness's record of window
    frames 40 and 41, whose host spans cover steps 2 and 3."""
    t0 = 10**12
    out = []
    for i in range(6):
        a = t0 + 20 * MS * i
        out.append(dict(step=i, spans=[trace.Span("step", i, None, "MainThread", a, a + 10 * MS)],
                        host_syncs={}, gc=[], launches={},
                        counts={"sam_encoder_images": images},
                        device_ms={"sam.encoder": [25.0]}))
    lo = (t0 + 40 * MS) * 1e-9
    record = dict(frames=[40, 41], spans=[("YOLO11 Inference", f, lo + k * 0.02, lo + k * 0.02 + 0.005)
                                          for k, f in enumerate([40, 41])],
                  flops_per_image=X_FLOPS + ENCODER_FLOPS + 20 * DECODER_FLOPS)
    return out, record


def test_encoder_roofline_reads_the_device_span(monkeypatch):
    steps, record = _steps(2)
    monkeypatch.setattr(trace, "records", lambda: steps)
    s = SAM_ARCH.VIT_H
    flops_ms = 2 * ENCODER_FLOPS / 989e12 * 1e3
    bytes_ms = (SAM_ARCH.encoder_weight_bytes(s)
                + 2 * SAM_ARCH.encoder_activation_bytes(s)) / 3.35e12 * 1e3
    assert flops_ms > bytes_ms
    assert spec.metric_reader("sam_encoder_roofline_pct")(record) == pytest.approx(
        100.0 * flops_ms / 25.0)
    # a cell of other sizes (here the tiny SAM's) is not bounded at ViT-H's
    with pytest.raises(ValueError, match="ViT-H"):
        spec.metric_reader("sam_encoder_roofline_pct")(
            dict(record, flops_per_image=X_FLOPS + SAM_ARCH.encoder_flops(TINY)))
    for rec in steps:  # a program without the device span (the parent's)
        del rec["device_ms"]
    assert spec.metric_reader("sam_encoder_roofline_pct")(record) is None
    assert spec.metric_reader("sam_ms")(record) is None


def test_sam_ms_reads_the_steps_sam_spans(stepped, monkeypatch):
    """`sam_ms` over the step's own record: its `sam.*` spans, each once;
    no roofline without a device span."""
    rec = stepped[2]
    root = rec["spans"][0]
    record = dict(frames=[0], spans=[("YOLO11 Inference", 0, root.start_ns * 1e-9 + 1e-6,
                                      root.end_ns * 1e-9 - 1e-6)])
    monkeypatch.setattr(trace, "records", lambda: [rec])
    want = sum(s.end_ns - s.start_ns for s in rec["spans"] if s.name.startswith("sam.")) / 1e6
    assert spec.metric_reader("sam_ms")(record) == pytest.approx(want)
    assert spec.metric_reader("sam_encoder_roofline_pct")(record) is None
