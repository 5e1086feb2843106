"""Synthetic datasets shaped like the paper's PubMed and SemMedDB graphs."""
