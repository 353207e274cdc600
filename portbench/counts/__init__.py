"""Operations and bytes from shapes: functions of a kernel's or a
configuration's sizes, not of any implementation."""
