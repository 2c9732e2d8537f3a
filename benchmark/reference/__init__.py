"""The plain reference: a NumPy scheduler that re-derives every decision
from the cluster description the traffic generator made. It imports
nothing of the program under test."""
