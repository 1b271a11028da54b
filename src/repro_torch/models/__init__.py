"""Models: the paper's deep CNN (the U-Net and the LLM zoo are not ported yet)."""
