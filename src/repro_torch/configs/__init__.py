"""Architecture registry: ``get(arch_id)`` resolves ``--arch`` flags.

Holds the dense GQA family, the mixture-of-experts family with GQA
attention (``qwen3-moe-235b-a22b``) and with MLA attention
(``deepseek-v2-236b``), the vision-language backbone (``internvl2-26b``),
the attention-free SSM family (``mamba2-1.3b``), the Mamba-2 +
shared-attention hybrid (``zamba2-1.2b``) and the encoder-decoder
(``whisper-base``): the reference's ten architectures.
"""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.mistral_nemo_12b import CONFIG as MISTRAL_NEMO
from repro_torch.configs.granite_3_2b import CONFIG as GRANITE
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2
from repro_torch.configs.whisper_base import CONFIG as WHISPER

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (TINYLLAMA, YI_6B, MISTRAL_NEMO, GRANITE, QWEN3_MOE, MAMBA2, ZAMBA2,
                        INTERNVL2, DEEPSEEK_V2, WHISPER)
}


def get(arch_id: str) -> ModelConfig:
    if arch_id.endswith("-smoke"):
        return ARCHS[arch_id[: -len("-smoke")]].smoke()
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ModelConfig", "get"]
