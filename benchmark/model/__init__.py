"""The yardstick's arithmetic: the encode's work on a card's peaks, and a
traced window reduced to busy time, device time by span and idle gaps."""
