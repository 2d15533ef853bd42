"""``replay(use_vertical=True)``: dual-sonar fusion on tests/test_frontends.py's
small dual-sonar bag, in both packages on the CPU.

* The slice up to the trajectory as in ``check_small_replay``: the same
  keyframes, loop count and feature masks, odometry within 1e-4 m. This
  survey's scan is ill-conditioned: the port's trajectory ends 0.039 m from
  the JAX replay's, whose odometry differs by 3.8e-6 m, and so does the JAX
  scan fed the port's keyframe inputs. Moving the port's odometry by 1e-6 m
  at random lands the JAX scan on three trajectories 0.062 m apart, and the
  port's scan on the JAX replay's (measured, five draws; ROADMAP queue 3).
  So the check is the other way round: the port's scan fed the JAX
  replay's keyframe inputs gives the JAX trajectory within 5e-4 m
  (measured 1.9e-6 m).
* The vertical detector: the port's strict-edge SOCA (the plain version on
  the CPU, the sum kernel on the card) against the JAX package's prefix-sum
  ``cfar_soca2`` on the keyframes' vertical pings: masks equal except at
  pixels within a relative 1e-5 of their threshold.
* The fusion stage: the JAX ``fuse_frames_global`` on the port's carry and
  vertical pings with the JAX masks gives the port's fused clouds, floor
  samples and elevation grid within 2e-5 (measured 1e-6).
"""

import numpy as np
import jax.numpy as jnp
import torch

import sonar_slam_tpu.slam.dual_sonar as jd
from sonar_slam_tpu.kernels.cfar import cfar_soca2
from sonar_slam_tpu.kernels.cfar_factors import threshold_factor_soca

from sonar_slam_torch.kernels.cfar_cuda import cfar_plain
from test_torch_frontends import DUAL_SIM, check_small_replay, small_replays

torch.set_num_threads(1)


def test_dual_replay_matches_jax():
    replays = small_replays(DUAL_SIM, use_vertical=True)
    check_small_replay(replays, odo_atol=1e-4, scan_atol=5e-4, own_atol=0.05,
                       scan_on="jax")
    bag, jdims, jparams, jres, tres = replays

    # the vertical detector on the keyframe slots' vertical pings
    K = jdims.max_keyframes
    kf = tres.keyframe_ping_idx
    sel = np.concatenate([kf, np.zeros(K - len(kf), np.int64)])
    vimgs = np.asarray(bag.vertical_images[sel], np.float32)
    tau = threshold_factor_soca(40, 0.1)
    jdet, jthr = [], []
    for im in vimgs:
        d, th = cfar_soca2(jnp.asarray(im), 20, 5, tau)
        jdet.append(np.asarray(d & (jnp.asarray(im) > 65.0)))
        jthr.append(np.asarray(th))
    jdet, jthr = np.stack(jdet), np.stack(jthr)
    tdet, tthr = cfar_plain(torch.as_tensor(vimgs), 20, 5, tau, "SOCA", 65.0,
                            "strict")
    diff = tdet.numpy() != jdet
    assert jdet.sum() > 100 and diff.sum() <= 0.001 * jdet.sum()
    np.testing.assert_allclose(tthr.numpy()[diff], jthr[diff], rtol=1e-5)

    # the fusion stage on the port's carry, with the JAX masks
    c = tres.carry
    spec = jd.ElevationSpec(*tres.elevation_spec)
    assert spec == jres.elevation_spec
    j = jd.fuse_frames_global(
        jnp.asarray(c.points.numpy()), jnp.asarray(c.pmasks.numpy()),
        jnp.asarray(vimgs), jnp.asarray(jdet), jnp.asarray(c.poses.numpy()),
        bag.vertical_geometry, spec)
    got = (tres.points3d, tres.points3d_mask, tres.floor_points3d,
           tres.floor_weights, tres.elevation_w, tres.elevation_z)
    want = (*j[:4], j[4].w, j[4].z)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=2e-5)
    zs = tres.points3d[..., 2][tres.points3d_mask & (tres.points3d[..., 2] != 0)]
    assert len(zs) > 10 and 2.0 < np.median(zs) < 6.0
