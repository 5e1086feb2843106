"""Three-term roofline of the dry run's records on the H100
(:mod:`repro_torch.roofline.analysis`)."""
