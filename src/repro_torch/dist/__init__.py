"""Distribution utilities: sharding-spec derivation for the config families
(:mod:`repro_torch.dist.sharding`, specs turned into DTensor placements) and
compressed collectives (:mod:`repro_torch.dist.compression`)."""
