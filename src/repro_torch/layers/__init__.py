"""Layers of the recommendation models: MLP stacks, embedding lookups,
feature interactions and the DIEN recurrent cells."""
