struct TReader {
  void skip_struct(int depth) {
    if (depth > 32) return;
    skip_value(12, depth);
  }
  void skip_value(int type, int depth);
};

void TReader::skip_value(int type, int depth) {
  if (type == 12) skip_struct(depth + 1);
}
