"""The benchmark's plain reference: the served CNNs written out layer by
layer (one module per architecture, named by a configuration's
``reference`` key) and run in DNNVM's fixed point with plain PyTorch
(``model.py`` on ``int8.py``).  It imports nothing of the program."""
