"""Models: the paper's deep CNN and the LLM zoo's dense (``Transformer``),
ssm (``Mamba2Model``) and hybrid (``Zamba2Model``) families; the U-Net,
MoE, the VLM stub and the encoder-decoder are not ported yet."""
