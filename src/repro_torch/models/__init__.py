"""Model building blocks (counterpart of ``repro.models``): so far the
parameter factory, the dense FFN and the MoE layer."""
