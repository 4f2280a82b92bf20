"""The padding's share of the bytes copied to the card: 100 · Σ
``pad_bytes`` / Σ ``bytes`` of the traced requests' ``tgp.collate.h2d``
spans."""

from portbench.harness.spans import attr_share


def read(ctx):
    return attr_share("tgp.collate.h2d", "pad_bytes", "bytes")
