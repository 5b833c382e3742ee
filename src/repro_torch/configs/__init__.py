"""Registry architectures: one module per arch (``ARCH_ID``, ``CONFIG``,
``smoke()``) and :mod:`.registry`, which resolves an arch id."""
