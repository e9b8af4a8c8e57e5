"""Analytic cost models of the port's datapaths."""
