"""The dense transformer family (torch twin of ``repro.models``)."""
