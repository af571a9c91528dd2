"""The yardstick's arithmetic: the card's published peaks, the FLOPs of a
step or a request counted on the reference, and the bytes a kernel must
move. A share of a peak or of a roofline reads the same work whatever
implements it."""
