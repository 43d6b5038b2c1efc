"""The port's copy of the communication stack the serving path rides."""
