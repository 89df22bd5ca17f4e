"""The MoE layer: gate, balance metrics, dispatch and fmoe."""
