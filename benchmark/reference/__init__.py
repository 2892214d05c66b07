"""Plain PyTorch references of what the benchmark checks and counts; they
import nothing of the program under test."""
