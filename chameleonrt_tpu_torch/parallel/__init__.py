from chameleonrt_tpu_torch.parallel.sharded import (  # noqa: F401
    make_mesh,
    make_sharded_render_step,
    padded_height,
    replicate_scene,
    shard_accum,
)
