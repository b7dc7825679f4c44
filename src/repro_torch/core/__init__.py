"""The port's copy of the framework-free core: store, manifest, layout,
crypto oracles, caches, the decode registry, the read and write paths,
the generational GC, the serial loader and the image service."""
