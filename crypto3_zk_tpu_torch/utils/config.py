"""Single typed configuration object.

Counterpart of `utils/config.py` of the JAX package: one dataclass carries
{field, curve, hashes, commitment parameters, mesh layout} and builds the
concrete params objects. `build_mesh` builds a
`torch.distributed.device_mesh.DeviceMesh` over the world the caller has
started (one rank a device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..fields import curves as CV
from ..fields import params as FP


@dataclasses.dataclass
class ZkTpuConfig:
    # math substrate
    field: str = "bls12_381_fr"          # proof field
    curve: Optional[str] = None          # pairing curve for KZG/Groth16
    # hashes
    transcript_hash: str = "keccak_256"  # keccak_256 | sha2_256 | poseidon
    merkle_hash: str = "poseidon"        # poseidon | keccak_256 | sha2_256
    # FRI / LPC
    fri_lambda: int = 40
    fri_expand_factor: int = 2
    fri_max_step: int = 1
    use_grinding: bool = False
    grinding_parameter: int = 0xFFFF
    max_quotient_chunks: int = 0
    # mesh / sharding
    mesh_shape: tuple = ()
    mesh_axes: tuple = ("x",)

    @property
    def fs(self) -> FP.FieldSpec:
        return FP.FIELDS[self.field]

    @property
    def curve_spec(self) -> Optional[CV.CurveSpec]:
        return CV.CURVES[self.curve] if self.curve else None

    def build_mesh(self):
        """A `DeviceMesh` of `mesh_shape` over the first ranks of the world
        the caller started (on the card for NCCL, the CPU for gloo), its
        dimensions named `mesh_axes`; None for an empty shape."""
        if not self.mesh_shape:
            return None
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        total = 1
        for s in self.mesh_shape:
            total *= s
        return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          torch.arange(total).reshape(tuple(self.mesh_shape)),
                          mesh_dim_names=tuple(self.mesh_axes))

    def build_fri_params(self, degree_log: int):
        from ..commitments.fri import FRIParams
        return FRIParams.build(
            self.fs, degree_log=degree_log,
            expand_factor=self.fri_expand_factor, lambda_=self.fri_lambda,
            merkle_hash=self.merkle_hash,
            transcript_hash=self.transcript_hash,
            use_grinding=self.use_grinding,
            grinding_parameter=self.grinding_parameter)

    def build_placeholder_params(self):
        from ..models.placeholder.common import PlaceholderParams
        return PlaceholderParams(self.fs,
                                 transcript_hash=self.transcript_hash,
                                 max_quotient_chunks=self.max_quotient_chunks)
