"""Pipelined chunk proving beside host aggregation."""
