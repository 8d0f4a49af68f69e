"""Wireless channel, cost, bandwidth, Lyapunov queues and JCSBA scheduling."""
