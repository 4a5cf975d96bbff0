"""The generator: its draws from the seed, its ping-pong play, and GT
corners that are the warps the frames were rendered with."""
import numpy as np
import pytest
import torch

from portbench.lib import generator, registry

MIX = registry.traffic("streams")


def make(seed, cameras=3, mix=MIX):
    torch.set_num_threads(2)
    return generator.make(mix, cameras, 480, 640, seed, torch.device("cpu"))


def test_same_seed_same_traffic():
    a, b = make(2 ** 31 + 12345), make(2 ** 31 + 12345)
    assert torch.equal(a.pool, b.pool)
    assert np.array_equal(a.gt, b.gt)
    assert np.array_equal(a.corners0, b.corners0)
    c = make(2 ** 31 + 12346)
    assert not torch.equal(a.pool, c.pool)
    assert not np.array_equal(a.corners0, c.corners0)


def test_every_seed_plays_the_same_cameras_in_another_order():
    """The seed draws the order of the mix's cameras, not the cameras: the
    same scene, and each camera's target, GT and frames whole."""
    a, c = make(2 ** 31 + 12345, cameras=8), make(2 ** 33 + 5, cameras=8)
    assert torch.equal(a.init_frame, c.init_frame)
    key = [tuple(x.ravel()) for x in a.corners0]
    order = [key.index(tuple(x.ravel())) for x in c.corners0]
    assert sorted(order) == list(range(8)) and order != list(range(8))
    assert np.array_equal(a.gt[:, order], c.gt)
    assert torch.equal(a.pool[:, order], c.pool)


def test_targets_and_sizes_follow_the_mix():
    s = make(7, cameras=64)
    c = s.corners0
    centre, half = c.mean(1), (c[:, 1, 0] - c[:, 0, 0]) / 2
    t = MIX["targets"]
    assert ((centre[:, 0] >= t["cx"][0]) & (centre[:, 0] <= t["cx"][1])).all()
    assert ((centre[:, 1] >= t["cy"][0]) & (centre[:, 1] <= t["cy"][1])).all()
    assert ((half >= t["half"][0]) & (half <= t["half"][1])).all()
    assert s.pool.shape == (3, 64, 480, 640) and s.gt.shape == (3, 64, 4, 2)
    # frame 0 is the scene, for every camera; the GT there is the targets
    assert torch.equal(s.pool[0], s.init_frame.expand(64, 480, 640))
    assert np.allclose(s.gt[0], c)
    assert not torch.equal(s.pool[1, 0], s.pool[1, 1])


def test_ping_pong():
    assert [generator.frame_index(k, 3) for k in range(9)] == \
        [0, 1, 2, 1, 0, 1, 2, 1, 0]
    assert [generator.frame_index(k, 2) for k in range(4)] == [0, 1, 0, 1]


def _bilinear(img, x, y):
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _bicubic(img, x, y):
    h, w = img.shape
    g = np.stack([x * 2 / (w - 1) - 1, y * 2 / (h - 1) - 1], -1)
    return torch.nn.functional.grid_sample(
        torch.as_tensor(img)[None, None], torch.as_tensor(g)[None, None],
        mode="bicubic", align_corners=True)[0, 0, 0].numpy()


@pytest.mark.parametrize("pool_seed, sample", [
    (11, _bilinear), (2 ** 32 + 7, _bilinear),
    (MIX["pool_seed"], _bicubic)])
def test_gt_is_the_rendered_warp(pool_seed, sample):
    """Frame t at the GT warp of a point of the target reads the scene at
    that point best: a fifth of a pixel off reads it worse, and one pixel
    off at least twice as badly. The mix's own pool is read with the
    renderer's bicubic kernel: read bilinearly, which blurs the texture's
    finest waves, one of its first three cameras reads best 0.2 px off."""
    s = make(2 ** 31 + 3, mix={**MIX, "pool_seed": pool_seed})
    scene = s.init_frame.numpy().astype(np.float64)
    for b in range(3):
        c0 = s.corners0[b].astype(np.float64)
        g = np.stack(np.meshgrid(np.arange(np.ceil(c0[0, 0]), c0[1, 0], 3),
                                 np.arange(np.ceil(c0[0, 1]), c0[2, 1], 3)),
                     -1).reshape(-1, 2)
        for t in (1, 2):
            img = s.pool[t, b].numpy().astype(np.float64)
            # the warp from the target's corners to the GT corners
            h = _homography(c0, s.gt[t, b])
            q = generator.apply(h, g)
            want = scene[g[:, 1].astype(int), g[:, 0].astype(int)]

            def miss(dx, dy):
                return np.abs(sample(img, q[:, 0] + dx, q[:, 1] + dy)
                              - want).mean()

            err = miss(0.0, 0.0)
            near = min(miss(dx, dy) for dx, dy in ((0.2, 0), (-0.2, 0),
                                                   (0, 0.2), (0, -0.2)))
            assert err < near and miss(1.0, 0.0) > 2 * err, (b, t, err)


def _homography(src, dst):
    a, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs += [u, v]
    h = np.linalg.solve(np.array(a), np.array(rhs))
    return np.append(h, 1.0).reshape(3, 3)


def test_walk_steps_a_few_pixels():
    s = make(5, cameras=32)
    step = np.linalg.norm(s.gt[1] - s.gt[0], axis=-1).mean(-1)
    assert 0.2 < np.median(step) < 5.0
