"""A folded 3x3 conv and the 2x2 max pool after it in one launch:
`ops/conv_pool_cuda.conv_pool` (csrc/conv_pool.cu), the pairs
`models.detection.conv_pool_pairs` marks, and their route in
`DetectionModel.forward`.

On the CPU:
- `conv_pool_plain` in float32 is the unfused composition (conv, bias,
  activation, `F.max_pool2d`), bit for bit, with and without the unpooled
  output; in bf16 it rounds once;
- the registered op runs the plain version on a CPU tensor; unknown
  activations, and tensors outside the kernel's layout, raise;
- `route_of` holds the kernel's widths, as csrc/conv_pool.cu's checks do;
- the pairs: yolov3-tiny's first four (its fifth, 128 -> 256 channels, is
  wider than the kernel takes), none in yolov3, yolov3-spp or yolov5x6, and
  none where the pool is not 2x2 stride 2 (the ZeroPad + `MaxPool(2, 1)`
  pair), reads another layer, or follows a conv the kernel does not compute;
  a conv that a later layer reads keeps its unpooled output;
- the per-call route (a fake CUDA tensor stands in for the card's): the
  epilogue's conditions and even H and W;
- the CPU forward of a marked model equals the unmarked one, bit for bit;
- torch.export traces a folded bf16 yolov3-tiny on CUDA (fake) tensors
  through the op: four pairs, seven epilogues, two max pools (layers 9 and
  12);
- the counters, and `/health` reporting them.

On a card (skipped without one): the kernel against the plain version
within one bf16 unit in the last place (where |v| >= 2^-6; 2^-14 below,
`chip_smoke.bf16_ulps_apart`) at yolov3-tiny's four pairs at
batch 32 and 640 px, at a letterboxed 384x640 and at ragged small shapes,
and the wrapper refusing tensors outside its layout. On a host of two or
more cards, each card in turn after the first runs every route, and a
served yolov3-tiny batch runs on a mesh of every card. The served batch's
launch counts are in tests/test_torch_conv_epilogue.py.

The file imports no JAX. On a card, from the repository's root:

    python -m pytest tests/test_torch_conv_pool.py -q --noconftest
"""

import json
import re
import threading
import urllib.request
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from chip_smoke import bf16_ulps_apart
from torch_cores import share_cores  # noqa: F401 — autouse: torch's threads, a worker's share
from torch_narrow import narrow_cfg
from yolov3_tpu_torch.models.detect_head import Detect
from yolov3_tpu_torch.models.detection import DetectionModel, conv_pool_pairs, optimize_for_inference
from yolov3_tpu_torch.nn.activations import mish
from yolov3_tpu_torch.nn.modules import Conv, Upsample
from yolov3_tpu_torch.ops import conv_pool_cuda
from yolov3_tpu_torch.ops.conv_pool_cuda import ACT_FNS, ACTS, MAX_CIN, ROUTES, conv_pool, conv_pool_plain, route_of

FAKE_CUDA = torch.device("cuda", 0)


def channels_last(*shape, dtype=torch.float32, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype).contiguous(memory_format=torch.channels_last)


def operands(cin=16, cout=24, h=10, w=12, dtype=torch.float32):
    x = channels_last(2, cin, h, w, dtype=dtype)
    weight = channels_last(cout, cin, 3, 3, dtype=dtype, seed=1, scale=0.2)
    bias = torch.randn(cout, generator=torch.Generator().manual_seed(2)).to(dtype)
    return x, weight, bias


@pytest.mark.parametrize("keep", [False, True], ids=["pooled", "kept"])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_is_the_unfused_composition_in_f32(act, keep):
    x, weight, bias = operands()
    y = ACT_FNS[act](F.conv2d(x, weight, None, 1, 1) + bias.view(1, -1, 1, 1))
    pooled, unpooled = conv_pool_plain(x, weight, bias, act, keep)
    assert torch.equal(pooled, F.max_pool2d(y, 2, 2))
    assert pooled.is_contiguous(memory_format=torch.channels_last)
    if keep:
        assert torch.equal(unpooled, y) and unpooled.is_contiguous(memory_format=torch.channels_last)
    else:
        assert unpooled is None


@pytest.mark.parametrize("act", sorted(ACTS))
def test_plain_rounds_once_in_bf16(act):
    x, weight, bias = operands(dtype=torch.bfloat16)
    y = ACT_FNS[act](F.conv2d(x.float(), weight.float(), None, 1, 1) + bias.float().view(1, -1, 1, 1))
    pooled, unpooled = conv_pool_plain(x, weight, bias, act, keep=True)
    assert pooled.dtype == unpooled.dtype == torch.bfloat16
    assert torch.equal(pooled, F.max_pool2d(y, 2, 2).bfloat16()) and torch.equal(unpooled, y.bfloat16())
    # rounding is monotonic: the pooled values are the max of the rounded unpooled ones
    assert torch.equal(pooled, F.max_pool2d(unpooled.float(), 2, 2).bfloat16())


@pytest.mark.parametrize("keep", [False, True], ids=["pooled", "kept"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_on_cpu_runs_the_plain_version(dtype, keep):
    x, weight, bias = operands(cin=3, cout=16, dtype=dtype)
    want = conv_pool_plain(x, weight, bias, "silu", keep)
    launches = conv_pool.launches
    got = conv_pool(x, weight, bias, "silu", keep)
    assert torch.equal(got[0], want[0]) and (got[1] is None if not keep else torch.equal(got[1], want[1]))
    assert conv_pool.launches == launches  # the plain version counts no launch


def test_op_refuses_unknown_activations():
    x, weight, bias = operands()
    with pytest.raises(ValueError, match="activation"):
        conv_pool(x, weight, bias, "mish")


def cuda_kernel_refusals():
    """(tensors the CUDA kernel refuses, the words of its error): its checks run before any launch."""
    x, weight, bias = operands(dtype=torch.bfloat16)
    return {
        "NCHW x": ((x.contiguous(), weight, bias), "channels_last"),
        "odd width": ((channels_last(2, 16, 10, 11, dtype=torch.bfloat16), weight, bias), "even"),
        "float32": ((x.float(), weight.float(), bias.float()), "bf16"),
        "Cin 8": ((channels_last(2, 8, 10, 12, dtype=torch.bfloat16), weight[:, :8], bias), "weight"),
        "Cin 128": ((channels_last(2, 128, 10, 12, dtype=torch.bfloat16),
                     channels_last(24, 128, 3, 3, dtype=torch.bfloat16), bias), "weight"),
        "Cout 12": ((x, weight[:12], bias[:12]), "weight"),
        "stem to 24": ((channels_last(2, 3, 10, 12, dtype=torch.bfloat16), weight[:, :3], bias), "weight"),
        "1x1 weight": ((x, weight[:, :, :1, :1], bias), "weight"),
        "short bias": ((x, weight, bias[:8]), "bias"),
    }


@pytest.mark.parametrize("case", list(cuda_kernel_refusals()))
def test_cuda_kernel_refuses_other_layouts(case):
    args, words = cuda_kernel_refusals()[case]
    with pytest.raises(ValueError, match=words):
        conv_pool_cuda._conv_pool_cuda(*args, "silu", False)


@pytest.mark.parametrize("cin,cout,want", [(3, 16, "stem"), (3, 32, "stem"), (3, 24, None), (16, 32, "halo"),
                                           (128, 256, None), (64, 40, "halo"), (256, 512, None), (16, 12, None),
                                           (8, 16, None), (24, 32, None), (512, 1024, None), (64, 128, "halo"),
                                           (80, 160, None)])
def test_route_of_widths(cin, cout, want):
    assert route_of(cin, cout) == want


def test_route_of_is_the_kernels_limit():
    # route_of is the Python copy of the launch function's refusals: its MAX_CIN is csrc/conv_pool.cu's
    src = (Path(conv_pool_cuda.__file__).parent.parent / "csrc" / "conv_pool.cu").read_text()
    assert [int(v) for v in re.findall(r"constexpr int MAX_CIN = (\d+);", src)] == [MAX_CIN]
    assert "Cin % 16 == 0 && Cin <= MAX_CIN" in src and "Cin == 3 && (Cout == 16 || Cout == 32)" in src


# --- the pairs

def fake_cuda(t, mode):
    return FakeTensor(mode, t.to("meta"), FAKE_CUDA)


@pytest.mark.parametrize("name,want", [("yolov3-tiny", {0: False, 2: False, 4: False, 6: False}),
                                       ("yolov3", {}), ("yolov3-spp", {}), ("yolov5x6", {})])
def test_pairs_of_each_config(name, want):
    cfg = name if name == "yolov3-tiny" else narrow_cfg(name)  # yolov3-tiny at its published widths
    model = DetectionModel.from_config(cfg, seed=0, device="cpu")
    served = optimize_for_inference(model, bf16=True)
    assert served.conv_pool_pairs == want
    assert model.conv_pool_pairs == {} and model.fuse().conv_pool_pairs == {}  # only the inference form is marked
    assert optimize_for_inference(model, bf16=False).conv_pool_pairs == want  # the structure, whatever the dtype


def small_spec(*middle, stem=(16, 3, 1)):
    """A small spec: Conv(*stem), the `middle` rows, Conv(32, 3, 1), Detect."""
    rows = [{"from": -1, "n": 1, "op": "Conv", "args": list(stem)}, *middle,
            {"from": -1, "n": 1, "op": "Conv", "args": [32, 3, 1]},
            {"from": [-1], "n": 1, "op": "Detect", "args": ["nc", "anchors"]}]
    return {"name": "pairs", "nc": 2, "anchors": [[10, 14, 23, 27]], "layers": rows}


POOL_2_2 = {"from": -1, "n": 1, "op": "MaxPool", "args": [2, 2, 0]}
# layer 0 is also read by a stride-2 conv (layer 2), whose output the Concat (layer 3) joins to the pool's
READ_AGAIN = (POOL_2_2, {"from": 0, "n": 1, "op": "Conv", "args": [16, 3, 2]},
              {"from": [1, 2], "n": 1, "op": "Concat", "args": [1]})
PAIR_CASES = {  # name -> (spec, the pairs)
    "conv then MaxPool(2, 2, 0)": (small_spec(POOL_2_2), {0: False}),
    "nn.MaxPool2d spelling": (small_spec({**POOL_2_2, "op": "nn.MaxPool2d"}), {0: False}),
    "MaxPool(2, 1, 0)": (small_spec({**POOL_2_2, "args": [2, 1, 0]}), {}),
    "MaxPool(3, 2, 1)": (small_spec({**POOL_2_2, "args": [3, 2, 1]}), {}),
    "ZeroPad between": (small_spec({"from": -1, "n": 1, "op": "ZeroPad", "args": [[0, 1, 0, 1]]}, POOL_2_2), {}),
    "pool of another layer": (small_spec({"from": -1, "n": 1, "op": "Conv", "args": [16, 3, 1]},
                                         {**POOL_2_2, "from": -2}), {}),
    "a later layer reads the conv": (small_spec(*READ_AGAIN), {0: True}),
    "1x1 conv": (small_spec(POOL_2_2, stem=(16, 1, 1)), {}),
    "stride-2 conv": (small_spec(POOL_2_2, stem=(16, 3, 2)), {}),
    "stem to 24 channels": (small_spec(POOL_2_2, stem=(24, 3, 1)), {}),
    "mish": (small_spec(POOL_2_2), {}),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_rules(case):
    spec, want = PAIR_CASES[case]
    model = DetectionModel.from_config(spec, seed=0, device="cpu")
    fused = model.fuse()
    if case == "mish":
        fused.model[0].act = mish
    assert conv_pool_pairs(fused) == want
    assert conv_pool_pairs(model) == {}  # an unfolded conv (with its BatchNorm) pairs with nothing


def served_conv(c1=16, c2=32, act=True):
    return Conv(c1, c2, 3, 1, act=act, fused=True).eval().to(torch.bfloat16)


CALL_CASES = {  # name -> (the conv, how the input differs from the served one, whether the pair runs in one launch)
    "taken": (lambda: served_conv(), {}, True),
    "stem": (lambda: served_conv(c1=3, c2=16), dict(cin=3), True),
    "identity": (lambda: served_conv(act=False), {}, True),
    "leaky_relu": (lambda: served_conv(act="leakyrelu"), {}, True),
    "cpu": (lambda: served_conv(), dict(device="cpu"), False),
    "float32": (lambda: served_conv().float(), dict(dtype=torch.float32), False),
    "float16": (lambda: served_conv().half(), dict(dtype=torch.float16), False),
    "train mode": (lambda: served_conv().train(), {}, False),
    "graph recorded": (lambda: served_conv(), dict(grad=True), False),
    "odd height": (lambda: served_conv(), dict(h=7), False),
    "odd width": (lambda: served_conv(), dict(w=9), False),
}


@pytest.mark.parametrize("case", list(CALL_CASES))
def test_call_route(case):
    make, opt, want = CALL_CASES[case]
    conv = make()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dtype = opt.get("dtype", torch.bfloat16)
    x = channels_last(2, opt.get("cin", 16), opt.get("h", 8), opt.get("w", 10), dtype=dtype)
    if opt.get("device") != "cpu":
        conv._apply(lambda t: fake_cuda(t, mode))
        x = fake_cuda(x, mode)
    if opt.get("grad"):
        conv.requires_grad_(True)
        assert conv.forward_pooled(x, False) is None
        return
    with torch.no_grad():
        got = conv.forward_pooled(x, True)
    if not want:
        assert got is None
        return
    pooled, unpooled = got
    assert pooled.shape == (2, 32 if opt.get("cin") is None else 16, 4, 5) and pooled.dtype == torch.bfloat16
    assert pooled.is_contiguous(memory_format=torch.channels_last)
    assert unpooled.shape == (2, pooled.shape[1], 8, 10)


@pytest.mark.parametrize("name", ["yolov3-tiny", "pairs"])
def test_cpu_forward_of_a_marked_model_is_unchanged(name):
    cfg = narrow_cfg(name) if name == "yolov3-tiny" else small_spec(*READ_AGAIN)
    model = DetectionModel.from_config(cfg, seed=0, device="cpu")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    for bf16 in (True, False):
        served = optimize_for_inference(model, bf16=bf16)
        assert served.conv_pool_pairs
        with torch.inference_mode():
            got = served(x, raw=True)
            served.conv_pool_pairs = {}
            want = served(x, raw=True)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, bf16)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic batch"])
def test_export_traces_tiny_through_the_op(monkeypatch, dynamic):
    # the nearest upsample's decomposition and the head's biased conv ask a CPU-only build for CUDA layouts: the
    # upsample repeats the pixels instead, and the head hands back its inputs, the body's two outputs
    monkeypatch.setattr(Upsample, "forward", lambda self, x: x.repeat_interleave(self.scale, 2)
                        .repeat_interleave(self.scale, 3))
    monkeypatch.setattr(Detect, "forward", lambda self, xs, raw=False, raw_pad=0: tuple(xs))
    model = optimize_for_inference(DetectionModel.from_config(narrow_cfg("yolov3-tiny"), seed=0, device="cpu"),
                                   bf16=True)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    model._apply(lambda t: fake_cuda(t, mode))
    x = fake_cuda(torch.rand((2, 64, 64, 3)), mode)
    shapes = ({0: torch.export.Dim("batch", min=1, max=1024)},) if dynamic else None
    with torch.no_grad():
        program = torch.export.export(model.serving_module(), (x,), dynamic_shapes=shapes)
    ops = [n.target for n in program.graph.nodes]
    pools = [n for n in program.graph.nodes if n.target is torch.ops.yolov3_tpu_torch.conv_pool.default]
    assert len(pools) == 4 and [n.args[3:] for n in pools] == [("silu", False)] * 4
    assert ops.count(torch.ops.yolov3_tpu_torch.conv_epilogue.default) == 7
    assert ops.count(torch.ops.aten.max_pool2d.default) == 2  # layer 9's, after the 128 -> 256 conv, and layer 12's


def test_counters_name_every_route():
    assert set(conv_pool.route_launches) == {f"{r}_{a}" for r in ("stem", "halo")
                                             for a in ("silu", "identity", "leaky_relu")}
    assert ROUTES == ("stem", "halo") and isinstance(conv_pool.launches, int)


def test_health_reports_the_counters(tmp_path):
    from yolov3_tpu_torch import serve
    from yolov3_tpu_torch.utils.checkpoint import save_checkpoint

    model = DetectionModel.from_config(narrow_cfg("yolov3-tiny"), seed=0, device="cpu")
    ckpt = save_checkpoint(tmp_path / "best", {"model": model.state_dict()}, spec=model.spec)
    server = serve.make_server(ckpt, host="127.0.0.1", port=0, imgsz=64, max_batch=1, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            counters = json.loads(r.read())["counters"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert counters["conv_pool.launches"] == conv_pool.launches
    assert counters["conv_pool.route_launches"] == conv_pool.route_launches


# --- on a card

@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the plain version's conv in full float32
    return torch.device("cuda", 0)


# (B, Cin, Cout, H, W, act, keep): yolov3-tiny@640 batch 32's four pairs, the widest with its unpooled output kept
# too, the same at a letterboxed 384x640 frame, then ragged edges, channel tiles cut short and the other activations
CARD_SHAPES = [
    (32, 3, 16, 640, 640, "silu", False), (32, 16, 32, 320, 320, "silu", False),
    (32, 32, 64, 160, 160, "silu", False), (32, 64, 128, 80, 80, "silu", False),
    (32, 64, 128, 80, 80, "silu", True),
    (4, 3, 16, 384, 640, "silu", False), (4, 16, 32, 192, 320, "silu", False),
    (4, 32, 64, 96, 160, "silu", False), (4, 64, 128, 48, 80, "silu", False),
    (4, 64, 128, 48, 80, "silu", True),
    (3, 3, 32, 6, 10, "leaky_relu", True), (2, 3, 16, 2, 130, "identity", True),
    (3, 16, 24, 30, 40, "identity", True), (2, 48, 40, 18, 34, "leaky_relu", False),
    (1, 16, 8, 2, 2, "silu", True), (2, 32, 96, 10, 30, "silu", True),
]


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s[:5])) + f"-{s[5]}-{s[6]}")
def test_kernel_against_plain_on_the_card(card, shape):
    kernel_against_plain(card, shape)


def kernel_against_plain(device, shape):
    B, cin, cout, H, W, act, keep = shape
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((B, H, W, cin), generator=g, device=device).to(torch.bfloat16).permute(0, 3, 1, 2)
    scale = (9 * cin) ** -0.5 * 3
    weight = ((torch.rand((cout, 3, 3, cin), generator=g, device=device) * 2 - 1) * scale).to(torch.bfloat16)
    weight = weight.permute(0, 3, 1, 2)  # OIHW in channels_last
    bias = torch.randn((cout,), generator=g, device=device).to(torch.bfloat16)
    want = conv_pool_plain(x, weight, bias, act, keep)
    key = f"{route_of(cin, cout)}_{act}"
    launches, routed = conv_pool.launches, conv_pool.route_launches[key]
    pooled, unpooled = conv_pool(x, weight, bias, act, keep)
    torch.cuda.synchronize(device)
    assert conv_pool.launches == launches + 1 and conv_pool.route_launches[key] == routed + 1
    assert pooled.shape == want[0].shape and pooled.is_contiguous(memory_format=torch.channels_last)
    # one unit in the last place where |v| >= 2^-6; below, where the two orders of the f32 sum cancel, 2^-14
    ulps, below = bf16_ulps_apart(pooled, want[0])
    assert ulps <= 1 and below <= 2.0 ** -14
    if keep:
        ulps, below = bf16_ulps_apart(unpooled, want[1])
        assert ulps <= 1 and below <= 2.0 ** -14
        assert torch.equal(pooled, F.max_pool2d(unpooled, 2, 2))  # the two stores agree
    else:
        assert unpooled is None


def test_wrapper_refuses_other_layouts(card):
    x = torch.zeros((2, 16, 4, 4), device=card, dtype=torch.bfloat16)  # NCHW contiguous
    weight = torch.zeros((32, 16, 3, 3), device=card, dtype=torch.bfloat16)
    bias = torch.zeros(32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        conv_pool(x, weight, bias, "silu")
    cl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="even"):
        conv_pool(cl[:, :, :3], weight, bias, "silu")
    with pytest.raises(ValueError, match="bf16"):
        conv_pool(cl.float(), weight.float(), bias.float(), "silu")
    with pytest.raises(ValueError, match="bias"):
        conv_pool(cl, weight, bias[:8], "silu")
    pooled, _ = conv_pool(cl, weight.contiguous(), bias, "silu")  # an NCHW weight is copied into the layout
    assert pooled.shape == (2, 32, 2, 2)


@pytest.fixture
def cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards: this host has one")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# one shape of each kernel: the stem (Cin 3), the halo tiles of 32 channels and of 64 (128 KB of shared memory, over
# the 48 KB a launch gets unless its card's limit is raised)
EACH_KERNEL = [(2, 3, 16, 16, 130, "silu", False), (2, 16, 32, 34, 40, "silu", False),
               (2, 64, 128, 18, 40, "silu", True)]


def test_kernel_on_each_card_in_turn(cards):
    # a kernel's shared memory limit and the occupancy found for it belong to one card: each card after the first
    # sets and finds its own
    for device in cards:
        for shape in EACH_KERNEL:
            kernel_against_plain(device, shape)


def test_served_tiny_on_a_mesh_of_every_card(cards):
    from yolov3_tpu_torch import serve
    from yolov3_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    model = DetectionModel.from_config("yolov3-tiny", seed=0, device=cards[0])
    infer = serve.build_batched_infer(model, mesh=mesh)
    pairs = len(infer.serving_model.conv_pool_pairs)
    imgs = torch.randint(0, 256, (2 * mesh.size, 320, 320, 3), dtype=torch.uint8, device=cards[0])
    launches = conv_pool.launches
    dets, n = infer(imgs)[:2]
    for device in cards:
        torch.cuda.synchronize(device)
    assert conv_pool.launches - launches == pairs * mesh.size and pairs == 4
    assert dets.shape[0] == n.shape[0] == imgs.shape[0]
