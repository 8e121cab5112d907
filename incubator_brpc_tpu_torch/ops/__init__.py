"""Device-side ops (Pallas/jnp) for the TPU data plane: bulk transfer,
checksums, response merging. These are the hot ops of the framework —
the analog of the reference's writev/crc32c/memcpy inner loops, mapped
onto HBM/VMEM DMA and the VPU instead of the kernel's socket stack."""
