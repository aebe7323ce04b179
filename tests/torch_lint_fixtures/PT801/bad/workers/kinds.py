_DATA = 0
