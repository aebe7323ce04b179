struct TReader {
  void skip_struct() {
    skip_value(12);
  }
  void skip_value(int type);
};

void TReader::skip_value(int type) {
  if (type == 12) skip_struct();
}
