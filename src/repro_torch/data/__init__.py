"""Seeded synthetic request streams (a copy of ``repro.data``)."""
