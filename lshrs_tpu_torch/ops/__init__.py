"""Device compute: bitpack, the B1/B2 group-max kernels, selection and refine."""
