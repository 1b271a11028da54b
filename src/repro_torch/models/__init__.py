"""Models: the paper's deep CNN and U-Net, and the LLM zoo's dense, moe and
vlm (``Transformer``), audio (``EncoderDecoder``), ssm (``Mamba2Model``)
and hybrid (``Zamba2Model``) families."""
