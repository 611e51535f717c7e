"""One rank of the multi-process checks of ``tests/test_torch_parallel.py``.

Run as its own interpreter, one per rank:

    python tests/torch_dist_worker.py RANK WORLD STORE_FILE IN_FILE OUT_FILE

It joins a gloo process group through a ``FileStore``, runs the sharded
Monte Carlo sweep on the scenarios of ``IN_FILE`` (20 steps in chunks of 10)
and the sharded shielded fleet (two walls of 16, 4 chunks of 3 steps), and
saves what this rank holds afterwards to ``OUT_FILE``.  It imports PyTorch
and the port only.
"""

import sys

import torch


def main(rank: int, world: int, store_file: str, in_file: str, out_file: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from safe_control_tpu_torch.core.spec import KINEMATIC_BICYCLE_2D_DPCBF, make_spec
    from safe_control_tpu_torch.parallel import fleet as fl
    from safe_control_tpu_torch.parallel import fleet_scenarios as fs
    from safe_control_tpu_torch.parallel import mesh as mesh_mod
    from safe_control_tpu_torch.parallel import monte_carlo as mc
    from safe_control_tpu_torch.sim import tracking

    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        mesh = mesh_mod.scenario_mesh(world, device="cpu")
        data = torch.load(in_file, weights_only=False)
        spec = make_spec(KINEMATIC_BICYCLE_2D_DPCBF, a_max=5.0, radius=0.3)
        cfg = tracking.TrackerConfig(model_name=KINEMATIC_BICYCLE_2D_DPCBF,
                                     pos_controller="cbf_qp", dt=0.05, num_obs=8, qp_iters=400)
        sweep, res = mc.run_sharded_sweep(mesh, cfg, spec, data["sweep"], data["waypoints"], 2,
                                          20, chunk=10)
        groups, specs, x0s, wps, n_wps, known = fs.two_walls(16, "cpu")
        state = mesh_mod.shard_leading_axis(mesh, fl.init_shielded_fleet(groups, x0s))
        wps = mesh_mod.shard_leading_axis(mesh, wps)
        for _ in range(4):
            state = fl.step_fleet_shielded_sharded(groups, specs, state, wps, n_wps, known, mesh,
                                                   n_steps=3, k_neighbors=4)
        fleet = mesh_mod.gather_leading_axis(mesh, state)
        torch.save(dict(sweep=sweep, rates=(float(res.success_rate), float(res.collision_rate)),
                        fleet=fleet, jax_imported="jax" in sys.modules), out_file)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
