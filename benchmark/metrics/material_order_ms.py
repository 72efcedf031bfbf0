"""material_order_ms: the device windows of the program's spans
``juicy.order.gather`` (the material sort on the host, the clips, params,
states and rows gathered into slot order) and ``juicy.order.scatter``
(outputs, states and lanes put back in corpus order) summed per traced
batch, in milliseconds (benchmark/spans.py); absent where the corpus
takes no sorted route (a static material)."""

from benchmark import spans


def read(tr):
    return spans.phase_ms(tr, "juicy.order.gather", "juicy.order.scatter")
