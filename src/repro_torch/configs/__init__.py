"""Architecture registry: ``get(arch_id)`` resolves ``--arch`` flags.

Holds the dense GQA family; the other architectures are added with the
model families that run them.
"""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO
from repro_torch.configs.granite_3_2b import CONFIG as GRANITE

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (TINYLLAMA, YI_6B, MISTRAL_NEMO, GRANITE)
}


def get(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-smoke"):
        return ARCHS[arch_id[: -len("-smoke")]].smoke()
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ModelConfig", "get"]
