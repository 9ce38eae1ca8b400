"""Device compute: bitpack, the B1/B2/B3 group-max kernels, selection and refine."""
