"""The compiler core: graph IR, front end, quantization, fusion search,
lowering, int8 semantics, executor and validation."""
