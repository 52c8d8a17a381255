"""The roofline and FLOP arithmetic against hand counts at small shapes."""
import pytest
import torch
from wbench.bounds import KernelBounds, bound_ms, is_hand_kernel, plane_boxes, tapped_texels


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert bound_ms(0, 67e9) == pytest.approx(1.0)
    assert bound_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)


def test_plane_boxes_by_hand():
    tex = torch.zeros(1, 5, 6, 2)
    tex[0, 1, 2, 0] = 1.0
    tex[0, 3, 4, 0] = -2.0
    assert plane_boxes(tex).tolist() == [[[1, 3, 2, 4], [5, -1, 6, -1]]]


def test_tapped_texels_by_hand():
    # one sample at a texel centre's corner: its 4 taps, all on a 4x4 plane
    h = w = 4
    g = torch.tensor([[[[-0.25, -0.25]]]])  # x = y = 1.0 -> taps (1,1) (1,2) (2,1) (2,2)
    assert tapped_texels(g, torch.tensor([0]), h, w) == 4
    # two rows on one plane reading the same taps count them once
    g2 = g.expand(2, 1, 1, 2)
    assert tapped_texels(g2, torch.tensor([0, 0]), h, w) == 4
    assert tapped_texels(g2, torch.tensor([0, 1]), h, w) == 8
    # a sample off the texture's left edge reads only its in-range taps
    g3 = torch.tensor([[[[-1.1, -0.25]]]])  # x = -0.7 -> taps x -1 (out), 0
    assert tapped_texels(g3, torch.tensor([0]), h, w) == 2
    # with a nonzero box the footprint misses, none
    box = torch.tensor([[3, 3, 3, 3]])
    assert tapped_texels(g, torch.tensor([0]), h, w, boxes=box) == 0
    # a dead sample (zero output gradient) reads none
    assert tapped_texels(g, torch.tensor([0]), h, w, alive=torch.zeros(1, 1, 1, dtype=bool)) == 0


def test_k2_launch_bytes_by_hand():
    kb = KernelBounds()
    img = torch.ones(2, 4, 4, 3)
    grid = torch.full((4, 1, 1, 2), -0.25)  # tp_sz 2: two rows a texture, 4 taps each
    kb._k2(img=img, grid=grid, tp_sz=2, need_img=False)
    # 2 textures x 4 texels x 3 channels + 4 outputs x 3 channels, 4 bytes; grids 8 bytes a pixel
    nbytes = 4 * (2 * 4 * 3 + 4 * 3) + 8 * 4
    assert kb.ms == pytest.approx(bound_ms(nbytes, 4 * (16 + 8 * 3)))
    assert kb.launches == {"grid_sample": 1}


def test_k2pc_launches_its_prepass():
    kb = KernelBounds()
    img = torch.zeros(1, 4, 4, 2)
    img[0, 1, 1, 0] = 1.0
    grids = torch.full((1, 2, 1, 1, 2), -0.25)
    kb._k2pc(img=img, grids=grids, need_img=False)
    assert kb.launches == {"plane_boxes": 1, "grid_sample_per_channel": 1}
    pre = bound_ms(2 * img.numel() * 4 + 16 * 2, img.numel())
    # channel 0's box holds (1, 1): the footprint meets it, 4 texels; channel 1 is empty
    assert kb.ms == pytest.approx(pre + bound_ms(4 * 4 + 12 * 2, 24 * 2))


def test_hand_kernel_names():
    assert is_hand_kernel("void grid_sample_shared_kernel<float, 22>(Params)")
    assert is_hand_kernel("warp_alpha_ctx_kernel(Params)")
    assert not is_hand_kernel("void at::native::vectorized_elementwise_kernel<4>")


def test_model_flops_by_hand():
    from wbench.flops import ModelFlops

    x, w = torch.randn(1, 3, 8, 8), torch.randn(5, 3, 3, 3)
    with ModelFlops() as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
        torch.relu(x)  # no model FLOPs
    assert fc.total == 2 * 3 * 5 * 9 * 8 * 8
    # a product's backward counts twice its forward, parameters asking for
    # a gradient under inference mode count too
    a = torch.randn(4, 6, requires_grad=True)
    b = torch.randn(6, 7, requires_grad=True)
    with ModelFlops() as fc:
        torch.autograd.grad((a @ b).sum(), [a, b])
    assert fc.total == 3 * 2 * 4 * 6 * 7
    with torch.inference_mode(), ModelFlops() as fc:
        a @ b
    assert fc.total == 2 * 4 * 6 * 7
