"""``cli.lane_bits``: the step-by-step and call-by-call comparison of the
lane-batched sweep with lone scans, on the CPU at a short survey, with the
sweep's ICP and with bench.py's production (point-to-line) ICP. On the
CPU a lane may part from its lone scan by rounding (see
``tests/test_torch_sweep_lanes.py``); every lane-batched call is compared,
and the checked lanes' poses stay within 1e-6 m of the lone steps."""

from sonar_slam_torch.cli import lane_bits


def _check(out):
    assert out["lanes"] == 3 and out["check"] == [0, 2]
    calls = out["calls"]
    for name in ("global_initialize_lanes", "icp_pairs", "conf_weight_lanes",
                 "optimize_with_marginal_lanes", "optimize_batch",
                 "_assemble_normal_equations"):
        assert calls[name]["calls"] > 0, name
    for lane_steps in out["steps_parted"].values():
        for fields in lane_steps.values():
            assert fields.get("poses", 0.0) <= 1e-6


def test_lane_bits_compares_every_step_and_call():
    out = lane_bits.main(["--cpu", "--lanes", "3", "--check", "0,2",
                          "--duration", "24"])
    assert out["dims"] == {}
    _check(out)


def test_lane_bits_point_to_line():
    out = lane_bits.main(["--cpu", "--lanes", "3", "--check", "0,2",
                          "--duration", "24", "--production-icp"])
    assert out["dims"]["icp"]["point_to_line"]
    _check(out)
