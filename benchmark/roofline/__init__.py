"""Operations and bytes of the port's kernels at their call shapes, and the
card's peaks."""
