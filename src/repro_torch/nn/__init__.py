"""The LM substrate in PyTorch: models are dictionaries of tensors and pure
apply functions, as in the reference's ``nn`` package."""
