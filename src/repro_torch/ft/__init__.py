"""Fault tolerance: preemption guard and straggler monitor."""
