"""Model building blocks (counterpart of ``repro.models``): the parameter
factory and norms, the IRU embedding, GQA/MLA attention, Mamba-2, the dense
FFN, the MoE layer and the transformer stack (forward, prefill, decode)."""
