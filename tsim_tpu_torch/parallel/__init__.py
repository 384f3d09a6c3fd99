"""Multi-device sampling (counterpart of ``tsim_tpu/parallel``)."""

from .shard import ShotMesh, make_shot_mesh, sharded_sample_program, sharded_sampler_step

__all__ = ["ShotMesh", "make_shot_mesh", "sharded_sample_program", "sharded_sampler_step"]
