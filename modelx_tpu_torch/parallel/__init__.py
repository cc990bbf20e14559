"""Meshes and process groups (counterpart of ``modelx_tpu/parallel/``).

One process per card over ``torch.distributed``: ``distributed.initialize``
joins the group, ``mesh.make_mesh`` lays the ranks out on named axes and
gives each axis its process group. The collectives themselves are written
out where they happen (``models/llama.py``, ``ops/attention.py``).
"""

from modelx_tpu_torch.parallel.mesh import (
    AXIS_BATCH,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQUENCE,
    AXIS_STAGE,
    Mesh,
    MeshSpec,
    make_mesh,
    mesh_str,
    parse_mesh_spec,
    weight_shard_factor,
)

__all__ = [
    "AXIS_BATCH",
    "AXIS_EXPERT",
    "AXIS_FSDP",
    "AXIS_MODEL",
    "AXIS_SEQUENCE",
    "AXIS_STAGE",
    "Mesh",
    "MeshSpec",
    "make_mesh",
    "mesh_str",
    "parse_mesh_spec",
    "weight_shard_factor",
]
