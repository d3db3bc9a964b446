"""Share of their roofline the chain launches other than those with a 1x1
output reach over the traced calls (VGG16's nine conv and pool chains),
read from the executor-item spans as ``chain_fc_roofline`` reads its own."""
from portbench.metrics import chain_fc_roofline


def read(run):
    return chain_fc_roofline.share(run,
                                   lambda lc: not chain_fc_roofline.fc(lc))
