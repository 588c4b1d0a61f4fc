"""Deterministic solver core: fluxes, state and the MacCormack step."""
