"""The LM stack of the port: layers, attention (GQA and MLA; kernel K4 on
the prefill), the MoE FFN, Mamba-1 (kernel K5 on the prefill), the
transformer and the ``Model`` wrapper."""
from repro_torch.models.model import Model, carry_params, cross_entropy  # noqa: F401
